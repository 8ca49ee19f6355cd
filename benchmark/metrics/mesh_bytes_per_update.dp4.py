"""Bytes that rank 0 hands to the program's collectives in an update (the
program's counter ``mesh.bytes``: each collective's input), averaged over
the per-update records of the traced window (the window as
``metrics/mesh_wait_s.dp4.py`` reads it). None where the records hold no
such count."""
import statistics

COUNT = "mesh.bytes"


def read(ctx):
    records = (getattr(ctx, "rank_records", None) or [[]])[0]
    window = [r for r in records if 2 <= r["update"] < 2 + ctx.updates]
    if not any(COUNT in r["counts"] for r in window):
        return None
    return statistics.fmean(r["counts"].get(COUNT, 0) for r in window)

"""Host seconds an update waits in the program's per-step ``Mesh.any`` (its
span ``sync.mesh.any``: the blocking read of the flag that every rank's
all-reduce has set, so the wait for the card and for the slowest rank), in
each per-update record of the traced window, averaged over the window's
updates on each rank and then over the ranks. None where no rank's records
hold the span."""
import statistics

SPAN = "sync.mesh.any"


def read(ctx):
    per_rank = []
    for records in getattr(ctx, "rank_records", None) or []:
        window = [r for r in records if 2 <= r["update"] < 2 + ctx.updates]
        if any(SPAN in r["seconds"] for r in window):
            per_rank.append(statistics.fmean(r["seconds"].get(SPAN, 0.0) for r in window))
    return statistics.fmean(per_rank) if per_rank else None

"""Host seconds an update spends in the env step's observation: the
program's ``env.observe`` span (``observe``: Kuka's scene table and the
render3d launch, MobileRobot's render2d), summed in each per-update record
of the traced window and averaged (the window as ``metrics/sync_wait_s.py``
reads it)."""
import manifest


def read(ctx):
    return manifest.metric_reader("sync_wait_s").mean(
        ctx, lambda r: r["seconds"].get("env.observe", 0.0))

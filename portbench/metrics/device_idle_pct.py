"""Share of an ALTRO iteration in which the card runs nothing, in %:
1 - (device time per iteration in the profiled stretch / wall per
iteration of the unprofiled steps just before it).  The profiler slows the
host far more than the card, so the wall is the unprofiled one."""

from portbench.harness.window import idle_pct


def read(ctx):
    t = ctx["trace"]
    if (t is None or t["busy_s"] <= 0 or t["iters"] <= 0
            or t["unprofiled_iters"] <= 0):
        return None
    return idle_pct(t["busy_s"] / t["iters"],
                    t["unprofiled_wall_s"] / t["unprofiled_iters"])

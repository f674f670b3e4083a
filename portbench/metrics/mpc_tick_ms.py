"""Closed-loop control period: the window's time over the ticks completed
in it (host clock)."""


def read(ctx):
    w = ctx["window"]
    if ctx["kind"] != "mpc" or w["steps"] == 0:
        return None
    return 1e3 * w["elapsed"] / w["steps"]

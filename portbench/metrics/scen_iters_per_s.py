"""Planning throughput: the scenarios active in each ALTRO iteration of
the window, summed, over the window's time (host clock)."""


def read(ctx):
    w = ctx["window"]
    if ctx["kind"] != "plan" or w["elapsed"] <= 0:
        return None
    return w["work"] / w["elapsed"]

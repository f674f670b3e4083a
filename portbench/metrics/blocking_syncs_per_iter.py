"""Blocking synchronisations per ALTRO iteration in the profiled stretch:
the runtime's stream, device and event synchronisations and synchronous
copies, each of which drains the card's queue."""


def read(ctx):
    t = ctx["trace"]
    if t is None or t["iters"] <= 0 or t["busy_s"] <= 0:
        return None
    return t["syncs"] / t["iters"]

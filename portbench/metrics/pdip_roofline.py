"""The PDIP kernel's share of its roofline in the profiled stretch: the
launches' summed bound (operations at the published float32 peak or bytes
at the memory rate, whichever is larger, ``harness/roofline.py``) over
their summed device time in the trace, in %."""


def read(ctx):
    t = ctx["trace"]
    if t is None or not t["pdip"]:
        return None
    return 100.0 * (sum(r["bound_s"] for r in t["pdip"])
                    / sum(r["seconds"] for r in t["pdip"]))

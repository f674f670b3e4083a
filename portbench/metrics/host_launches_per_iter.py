"""Kernel launches the host issues per ALTRO iteration in the profiled
stretch: the CUDA runtime's launch calls in the trace, plus the PDIP
kernel's launches counted on the device where its library's runtime calls
do not show in the trace."""


def read(ctx):
    t = ctx["trace"]
    if t is None or t["iters"] <= 0 or t["busy_s"] <= 0:
        return None
    return t["launches"] / t["iters"]

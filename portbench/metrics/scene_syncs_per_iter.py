"""Blocking host-device synchronisations per ALTRO iteration that the
collision scene's code makes in the profiled stretch: those the port counts
under its ``scene.*`` spans (``dcol_tpu_torch.utils.trace``, by CUDA's sync
debug mode).  Read only for a step traced on the card, and not for a port
without that count."""


def read(ctx):
    t = ctx["trace"]
    if t is None or t["iters"] <= 0 or t["busy_s"] <= 0:
        return None
    try:
        from dcol_tpu_torch.utils.trace import RECORDER
    except ImportError:
        return None
    n = RECORDER.layer_syncs("scene")
    return None if n is None else n / t["iters"]

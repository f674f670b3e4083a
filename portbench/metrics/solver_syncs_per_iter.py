"""Blocking host-device synchronisations per ALTRO iteration that the
solver's code makes in the profiled stretch: those the port counts under
its ``altro.*`` and ``mpc.*`` spans (``dcol_tpu_torch.utils.trace``, by
CUDA's sync debug mode).  The harness's own synchronisations fall outside
the port's spans.  Read only for a step traced on the card, and not for a
port without that count."""


def read(ctx):
    t = ctx["trace"]
    if t is None or t["iters"] <= 0 or t["busy_s"] <= 0:
        return None
    try:
        from dcol_tpu_torch.utils.trace import RECORDER
    except ImportError:
        return None
    n = RECORDER.layer_syncs("solver")
    return None if n is None else n / t["iters"]

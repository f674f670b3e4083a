"""Mehrotra iterations per conic problem in the profiled stretch: the PDIP
iterations summed over the traced step's conic batches, over the problems
they solved (each batch's B less its skipped members), as the port counts
them (``dcol_tpu_torch.utils.trace.RECORDER``, noted in
``CollisionScene._solve``).  Read only for a step traced on the card, and
not for a port without that record."""


def read(ctx):
    t = ctx["trace"]
    if t is None or t["busy_s"] <= 0:
        return None
    try:
        from dcol_tpu_torch.utils.trace import RECORDER
    except ImportError:
        return None
    totals = RECORDER.pdip_totals().values()
    problems = sum(x["problems"] for x in totals)
    if problems <= 0:
        return None
    return sum(x["iters"] for x in totals) / problems

"""Host-side formatting of the solver's per-iteration metrics.  Port of
``dcol_tpu/utils/metrics.py::iteration_table``."""

from __future__ import annotations


def iteration_table(state, member: int = 0, limit: int | None = None) -> str:
    """Format one scenario's metric ring buffer like the reference's stdout
    table (ALTRO.py:437-440)."""
    m = state.metrics
    nb = m.J.shape[-1]
    it = int(state.iter[member])
    n = min(it, nb)
    if limit:
        n = min(n, limit)
    lines = []
    if it > nb:
        lines.append(
            f"[metrics buffer truncated: {it} iterations ran but the buffer "
            f"holds {nb}; iterations {nb}..{it} all wrote the last slot - "
            "raise AltroConfig.metrics_len for the full history]")
    lines += ["iter     J           dJ        |d|         a        reg"
              "         rho", "-" * 69]
    rows = [a[member, :n].tolist() for a in
            (m.J, m.delta_J, m.kmax, m.alpha, m.reg, m.rho)]
    for i, (J, dJ, km, a, reg, rho) in enumerate(zip(*rows)):
        lines.append(f"{i+1:3d}   {J:10.3e}  {dJ:9.2e}  {km:9.2e}  {a:6.4f}"
                     f"   {reg:9.2e}   {rho:9.2e}")
    return "\n".join(lines)

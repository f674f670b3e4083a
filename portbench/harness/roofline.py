"""The PDIP kernel's roofline: its operations and bytes, and the least
time the card can take for them.

A frozen copy of the arithmetic of ``dcol_tpu_torch/tools/roofline.py``
(``account``, ``pdip_bytes``, ``bound_seconds``) with its FLOP counts per
problem stored as data (``data/pdip_flops.json``), so that the count is
the same whatever implements the kernel.  All in float32, the type of the
kernel's operands and outputs."""

from __future__ import annotations

import json
import os
from typing import Dict, Tuple

_DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "data")
F32_BYTES = 4


def _load(name: str) -> dict:
    with open(os.path.join(_DATA, name)) as f:
        return json.load(f)


PEAKS = _load("peaks.json")
_WORK: Dict[Tuple, Tuple[float, float]] = {
    (r["nv"], r["n_ort"], r["s1"], r["s2"], r["start"] == "warm"):
        (r["init_flops"], r["flops_per_iter"])
    for r in _load("pdip_flops.json")["rows"]}


def work(nv: int, n_ort: int, s1: int, s2: int,
         warm: bool) -> Tuple[float, float]:
    """(init FLOPs, FLOPs per iteration) of one problem of the layout."""
    key = (nv, n_ort, s1, s2, warm)
    if key not in _WORK:
        raise KeyError(f"no FLOP count for PDIP layout {key}")
    return _WORK[key]


def pdip_bytes(nv: int, nr: int, warm: bool = False, skip: bool = False,
               skipped: bool = False) -> int:
    """Bytes one problem must move: c, G, h (and the warm x, s, z and the
    skip flag) read once; x, s, z, iters (int32) and converged (bool)
    written once.  A skipped problem reads the flag and the warm x, s, z,
    not c, G or h."""
    read = (0 if skipped else nv + nr * nv + nr) + (
        nv + 2 * nr if warm or skipped else 0)
    return F32_BYTES * (read + nv + 2 * nr) + 4 + 1 + (
        1 if skip or skipped else 0)


def bound_seconds(flops: float, nbytes: float) -> float:
    """The least time for ``flops`` at the float32 peak and ``nbytes`` at
    the memory rate: the larger of the two."""
    return max(flops / PEAKS["float32_flops_per_s"],
               nbytes / PEAKS["hbm_bytes_per_s"])


def launch(nv: int, n_ort: int, s1: int, s2: int, start: str, B: int,
           iters_sum: float, n_skip: int = 0) -> Dict[str, float]:
    """FLOPs, bytes and bound of one launch of B problems (``start`` is
    "cold", "warm" or "warm+skip", ``n_skip`` of them skipped) that ran
    ``iters_sum`` iterations over its problems."""
    warm, skip = start != "cold", start == "warm+skip"
    init, per_iter = work(nv, n_ort, s1, s2, warm)
    nr = n_ort + s1 + s2
    flops = B * init + per_iter * iters_sum
    nbytes = ((B - n_skip) * pdip_bytes(nv, nr, warm, skip)
              + n_skip * pdip_bytes(nv, nr, skipped=True))
    return {"flops": flops, "bytes": nbytes,
            "bound_s": bound_seconds(flops, nbytes)}

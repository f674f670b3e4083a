"""Wrapper of the hand-written Hopper PDIP kernel (``csrc/pdip.cu``).

Counterpart of ``dcol_tpu/ops/pdip_pallas.py::solve_socp_pallas`` with the
same (B, ...) convention as :func:`dcol_tpu_torch.ops.pdip.solve_socp`, its
plain PyTorch version.

The kernel is specialised per (dtype, nv, cone layout).  Each specialisation
is compiled at first use with ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface (``-D`` defines pick the layout), cached
under ``dcol_tpu_torch/build/`` keyed by a hash of the source and the flags,
and bound with ``ctypes`` (:mod:`dcol_tpu_torch.ops.nvcc_build`).  Nothing
is built at import, so the module imports on machines without ``nvcc``.

The wrapper takes CUDA tensors only and raises on anything else: a CPU
tensor, a dtype or layout it cannot build, a failed build or a launch error.
It never falls back to the plain version.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import torch

from dcol_tpu_torch.ops import nvcc_build
from dcol_tpu_torch.ops.cones import ConeLayout
from dcol_tpu_torch.ops.nvcc_build import Build
from dcol_tpu_torch.ops.pdip import SocpSolution, check_args

SOURCE = os.path.join(nvcc_build.CSRC, "pdip.cu")

# Kernel launches made by solve_socp_cuda (one per call with B > 0).
launches = 0

_CTYPE = {torch.float32: "float", torch.float64: "double"}


def _key(dtype, nv: int, lay: ConeLayout) -> Tuple:
    if dtype not in _CTYPE:
        raise TypeError(f"PDIP kernel supports float32/float64, got {dtype}")
    return ("pdip", dtype, nv, lay.n_ort, lay.s1, lay.s2)


def build(dtype, nv: int, lay: ConeLayout) -> Build:
    """Compile (or find in the cache) the library for one specialisation."""
    key = _key(dtype, nv, lay)
    t = _CTYPE[dtype]
    return nvcc_build.build(
        key, SOURCE, f"pdip_{t}_{nv}_{lay.n_ort}_{lay.s1}_{lay.s2}",
        [f"-DDCOL_T={t}", f"-DDCOL_NV={nv}", f"-DDCOL_NORT={lay.n_ort}",
         f"-DDCOL_S1={lay.s1}", f"-DDCOL_S2={lay.s2}"])


def _lib(dtype, nv: int, lay: ConeLayout) -> ctypes.CDLL:
    want = (torch.finfo(dtype).bits // 8, nv, lay.n_ort, lay.s1, lay.s2)

    def bind(lib: ctypes.CDLL) -> None:
        lib.dcol_pdip_layout.argtypes = [ctypes.POINTER(ctypes.c_int)]
        lib.dcol_pdip_layout.restype = ctypes.c_int
        lib.dcol_pdip_solve.argtypes = (
            [ctypes.c_void_p] * 12 + [ctypes.c_int, ctypes.c_double,
                                      ctypes.c_double, ctypes.c_double,
                                      ctypes.c_int, ctypes.c_void_p])
        lib.dcol_pdip_solve.restype = ctypes.c_int
        got = (ctypes.c_int * 5)()
        lib.dcol_pdip_layout(got)
        if tuple(got) != want:
            raise RuntimeError(f"library {lib._name} was built for "
                               f"{tuple(got)}, expected {want}")

    return nvcc_build.load(build(dtype, nv, lay), bind)


def _soa(a: torch.Tensor) -> torch.Tensor:
    """(B, d) -> (d, B) contiguous: neighbouring threads, neighbouring
    addresses."""
    return a.reshape(a.shape[0], -1).t().contiguous()


def solve_socp_cuda(c, G, h, lay: ConeLayout, *, tol: float = 1e-6,
                    max_iters: int = 30, jitter: float = 0.0,
                    warm=None, skip: Optional[torch.Tensor] = None,
                    warm_margin: float = 1e-3) -> SocpSolution:
    """Batched solve on the card: c (B, nv), G (B, nr, nv), h (B, nr).

    ``warm``: optional (x, s, z) from a previous nearby solve; ``skip``:
    optional (B,) bool of members whose result the caller discards (they
    return the warm-initialised iterate with zero iterations; needs
    ``warm``).  Same semantics as the plain ``solve_socp``."""
    global launches
    if G.dim() != 3:
        raise ValueError(f"G must be (B, nr, nv), got {tuple(G.shape)}")
    check_args(c, G, h, lay, warm, skip)
    tensors = [c, G, h] + (list(warm) if warm is not None else [])
    for t in tensors + ([skip] if skip is not None else []):
        if not t.is_cuda:
            raise ValueError("solve_socp_cuda takes CUDA tensors only; CPU "
                             "tensors go to ops.pdip.solve_socp")
    dt = G.dtype
    if any(t.dtype != dt for t in tensors):
        raise TypeError("c, G, h and warm must share one dtype")
    B, nr, nv = G.shape
    lib = _lib(dt, nv, lay)
    dev = G.device
    x = torch.empty((nv, B), dtype=dt, device=dev)
    s = torch.empty((nr, B), dtype=dt, device=dev)
    z = torch.empty((nr, B), dtype=dt, device=dev)
    iters = torch.empty((B,), dtype=torch.int32, device=dev)
    conv = torch.empty((B,), dtype=torch.bool, device=dev)
    if B == 0:
        return SocpSolution(x.t(), s.t(), z.t(), iters, conv)
    Gs = G.permute(2, 1, 0).contiguous()  # (nv, nr, B): row v*nr + r
    hs, cs = _soa(h), _soa(c)
    ops = [Gs, hs, cs]
    if warm is not None:
        ops += [_soa(w) for w in warm]
    else:
        ops += [None, None, None]
    if skip is not None:
        ops.append(skip.to(torch.bool).expand(B).contiguous())
    else:
        ops.append(None)
    ptr = lambda t: None if t is None else t.data_ptr()
    rc = lib.dcol_pdip_solve(
        *[ptr(t) for t in ops], x.data_ptr(), s.data_ptr(), z.data_ptr(),
        iters.data_ptr(), conv.data_ptr(), B, float(tol), float(jitter),
        float(warm_margin), int(max_iters),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"PDIP kernel launch failed: cudaError {rc} "
                           f"(layout nv={nv}, {lay}, B={B})")
    launches += 1
    return SocpSolution(x.t(), s.t(), z.t(), iters, conv)

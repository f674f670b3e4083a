"""Wrapper of the hand-written Hopper PDIP kernel (``csrc/pdip.cu``).

Counterpart of ``dcol_tpu/ops/pdip_pallas.py::solve_socp_pallas`` with the
same (B, ...) convention as :func:`dcol_tpu_torch.ops.pdip.solve_socp`, its
plain PyTorch version.

The kernel is specialised per (dtype, arithmetic type, nv, cone layout, team
size): it reads and writes the caller's dtype and iterates in
``arith_dtype(dtype, lay)``, and a team of ``team_lanes(nr, arithmetic
type)`` lanes solves each problem.  Each specialisation is
compiled at first use with ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface (``-D`` defines pick it), cached under
``dcol_tpu_torch/build/`` keyed by a hash of the source and the flags, and
bound with ``ctypes`` (:mod:`dcol_tpu_torch.ops.nvcc_build`).  Nothing is
built at import, so the module imports on machines without ``nvcc``.

The kernel reads c (B, nv), G (B, nr, nv), h (B, nr) and the warm start in
the row-major layout its callers hold them in, and writes x, s and z the
same way: the wrapper copies an operand only if the caller passed a strided
one.

The wrapper takes CUDA tensors only and raises on anything else: a CPU
tensor, a dtype or layout it cannot build, a failed build or a launch error.
It never falls back to the plain version.
"""

from __future__ import annotations

import collections
import ctypes
import os
import threading
from typing import Optional, Tuple

import torch

from dcol_tpu_torch.ops import nvcc_build
from dcol_tpu_torch.ops.cones import ConeLayout
from dcol_tpu_torch.ops.nvcc_build import Build
from dcol_tpu_torch.ops.pdip import SocpSolution, check_args

SOURCE = os.path.join(nvcc_build.CSRC, "pdip.cu")

# Kernel launches made by solve_socp_cuda (one per call with B > 0), and the
# same launches by shape: (B, nv, n_ort, s1, s2, start) -> count, where start
# is "cold", "warm" or "warm+skip".  Counted under a lock: the scenario mesh
# launches from one host thread per device.
launches = 0
tally: collections.Counter = collections.Counter()
_COUNT_LOCK = threading.Lock()

_CTYPE = {torch.float32: "float", torch.float64: "double"}


def arith_dtype(dtype, lay: ConeLayout):
    """The type the kernel iterates in for problems of ``dtype`` and cone
    layout ``lay``: float64 for a float32 problem with a second-order-cone
    block, otherwise ``dtype`` itself.  Near contact such a float32
    problem's scaled Newton system is ill-conditioned near tol: iterated in
    float32, the kernel stopped far from tol on a few of them in millions,
    on lanes that rounding picks (PERF.md §6); iterated in float64 from
    the same float32 operands, every one measured converges.  A purely orthant layout (the
    piano's) is iterated in float32, as before."""
    if dtype == torch.float32 and lay.s1 + lay.s2 > 0:
        return torch.float64
    return dtype


def team_lanes(nr: int, arith) -> int:
    """Lanes of the team that solves one problem of ``nr`` rows iterated in
    the type ``arith`` (:func:`arith_dtype`): 4 in float32, 8 in float64,
    never more than the power of two at or above ``nr`` and never fewer
    than 2.  A float64 iterate holds twice the registers of a float32 one,
    and a wider team holds fewer orthant rows a lane.  Float32 teams of 2
    were 13% faster than 4 on the main path's launches (PERF.md §6) but
    are not judged by the per-lane rule; no layout with an SOC block is
    iterated in float32 any more."""
    cap = 4 if arith == torch.float32 else 8
    team = 2
    while team < min(nr, cap):
        team *= 2
    return team


def _key(dtype, nv: int, lay: ConeLayout) -> Tuple:
    if dtype not in _CTYPE:
        raise TypeError(f"PDIP kernel supports float32/float64, got {dtype}")
    arith = arith_dtype(dtype, lay)
    return ("pdip", dtype, arith, nv, lay.n_ort, lay.s1, lay.s2,
            team_lanes(lay.nr, arith))


def build(dtype, nv: int, lay: ConeLayout) -> Build:
    """Compile (or find in the cache) the library for one specialisation:
    storage ``dtype``, arithmetic ``arith_dtype(dtype, lay)``, a team of
    ``team_lanes`` lanes.  Both types are in the library's name and
    flags, so the cache never hands back another type's library."""
    key = _key(dtype, nv, lay)
    arith, team = key[2], key[-1]
    t, a = _CTYPE[dtype], _CTYPE[arith]
    return nvcc_build.build(
        key, SOURCE,
        f"pdip_{t}_{a}_{nv}_{lay.n_ort}_{lay.s1}_{lay.s2}_t{team}",
        [f"-DDCOL_T={t}", f"-DDCOL_A={a}", f"-DDCOL_NV={nv}",
         f"-DDCOL_NORT={lay.n_ort}", f"-DDCOL_S1={lay.s1}",
         f"-DDCOL_S2={lay.s2}", f"-DDCOL_TEAM={team}"])


def _lib(dtype, nv: int, lay: ConeLayout) -> ctypes.CDLL:
    arith = arith_dtype(dtype, lay)
    want = (torch.finfo(dtype).bits // 8, torch.finfo(arith).bits // 8, nv,
            lay.n_ort, lay.s1, lay.s2)
    team = team_lanes(lay.nr, arith)

    def bind(lib: ctypes.CDLL) -> None:
        lib.dcol_pdip_layout.argtypes = [ctypes.POINTER(ctypes.c_int)]
        lib.dcol_pdip_layout.restype = ctypes.c_int
        lib.dcol_pdip_team.argtypes = []
        lib.dcol_pdip_team.restype = ctypes.c_int
        lib.dcol_pdip_solve.argtypes = (
            [ctypes.c_void_p] * 12 + [ctypes.c_int, ctypes.c_double,
                                      ctypes.c_double, ctypes.c_double,
                                      ctypes.c_int, ctypes.c_void_p])
        lib.dcol_pdip_solve.restype = ctypes.c_int
        got = (ctypes.c_int * 6)()
        lib.dcol_pdip_layout(got)
        if tuple(got) != want or lib.dcol_pdip_team() != team:
            raise RuntimeError(f"library {lib._name} was built for "
                               f"{tuple(got)}, team {lib.dcol_pdip_team()}; "
                               f"expected {want}, team {team}")

    return nvcc_build.load(build(dtype, nv, lay), bind)


def operands(c, G, h, warm=None, skip=None) -> list:
    """The kernel's inputs in its order (G, h, c, x, s, z, skip), each
    row-major and contiguous: the caller's own tensor where it already is
    (no copy), a contiguous copy of a strided one, None where absent."""
    ops = [G, h, c] + (list(warm) if warm is not None else [None] * 3)
    ops.append(None if skip is None
               else skip.to(torch.bool).expand(G.shape[0]))
    return [None if t is None else t.contiguous() for t in ops]


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
    x = torch.empty((B, nv), dtype=dt, device=dev)
    s = torch.empty((B, nr), dtype=dt, device=dev)
    z = torch.empty((B, nr), dtype=dt, device=dev)
    iters = torch.empty((B,), dtype=torch.int32, device=dev)
    conv = torch.empty((B,), dtype=torch.bool, device=dev)
    if B == 0:
        return SocpSolution(x, s, z, iters, conv)
    # held until the launch is queued: a copy made for a strided operand
    # must not go back to the allocator before the kernel is on the stream
    ops = operands(c, G, h, warm, skip)
    ptr = lambda t: None if t is None else t.data_ptr()
    rc = lib.dcol_pdip_solve(
        *[ptr(t) for t in ops], x.data_ptr(),
        s.data_ptr(), z.data_ptr(), iters.data_ptr(), conv.data_ptr(), B,
        float(tol), float(jitter), float(warm_margin), int(max_iters),
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"PDIP kernel launch failed: cudaError {rc} "
                           f"(layout nv={nv}, {lay}, team "
                           f"{_key(dt, nv, lay)[-1]}, B={B})")
    start = ("cold" if warm is None else
             "warm" if skip is None else "warm+skip")
    with _COUNT_LOCK:
        launches += 1
        tally[(B, nv, lay.n_ort, lay.s1, lay.s2, start)] += 1
    return SocpSolution(x, s, z, iters, conv)

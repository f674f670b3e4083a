"""Wrapper of the hand-written rollout kernel (``csrc/rollout.cu``).

One launch runs a whole rollout of the quadrotor: the closed loop of
:func:`dcol_tpu_torch.solver.altro.rollout_loop` (``u = U_t - K_t (x - X_t)
- alpha k_t`` and an RK4 step of ``Quadrotor.dynamics`` a knot, for every
scenario and candidate step size) or the open loop of
``initial_rollout_loop``, which are its plain versions.  The JAX package
runs the same rollouts as a ``lax.scan``; no Pallas kernel stands behind
them.

The kernel is specialised per dtype (float32, float64) and computes in it.
Each specialisation is compiled at first use with ``nvcc`` for ``sm_90a``
into its own shared library with a plain C interface, cached under
``dcol_tpu_torch/build/`` keyed by a hash of the source and the flags, and
bound with ``ctypes`` (:mod:`dcol_tpu_torch.ops.nvcc_build`).  Nothing is
built at import.

The quadrotor's constants (mass, inertia, gravity, arm length, rotor
coefficients) are read from :mod:`dcol_tpu_torch.systems.quadrotor`, their
one source, and passed by value with the system's ``dt`` at each launch:
nothing is copied to the card but the operands the caller holds there.

The wrapper takes CUDA tensors only and raises on anything else: a CPU
tensor, another dtype, a shape it does not take, a failed build or a
launch error.  It never falls back to the loop.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import List, Sequence, Tuple

import torch

from dcol_tpu_torch.ops import nvcc_build
from dcol_tpu_torch.ops.nvcc_build import Build

SOURCE = os.path.join(nvcc_build.CSRC, "rollout.cu")
NX, NU = 12, 4

# Kernel launches made by rollout_cuda and initial_rollout_cuda (one per
# call with lanes), counted under a lock: the scenario mesh launches from
# one host thread per device.
launches = 0
_COUNT_LOCK = threading.Lock()

_CTYPE = {torch.float32: "float", torch.float64: "double"}


def build(dtype) -> Build:
    """Compile (or find in the cache) the kernel for one dtype."""
    if dtype not in _CTYPE:
        raise TypeError(f"rollout kernel supports float32/float64, got "
                        f"{dtype}")
    t = _CTYPE[dtype]
    return nvcc_build.build(("rollout", dtype), SOURCE, f"rollout_{t}",
                            [f"-DDCOL_T={t}"])


def _lib(dtype) -> ctypes.CDLL:
    def bind(lib: ctypes.CDLL) -> None:
        lib.dcol_rollout_layout.argtypes = [ctypes.POINTER(ctypes.c_int)]
        lib.dcol_rollout_layout.restype = ctypes.c_int
        lib.dcol_rollout.argtypes = (
            [ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 7
            + [ctypes.c_int] * 3
            + [ctypes.POINTER(ctypes.c_double), ctypes.c_void_p])
        lib.dcol_rollout.restype = ctypes.c_int
        got = (ctypes.c_int * 3)()
        lib.dcol_rollout_layout(got)
        want = (torch.finfo(dtype).bits // 8, NX, NU)
        if tuple(got) != want:
            raise RuntimeError(f"library {lib._name} was built for "
                               f"{tuple(got)}; expected {want}")

    return nvcc_build.load(build(dtype), bind)


def constants(sys) -> Tuple[float, ...]:
    """(mass, J_x, J_y, J_z, gravity, arm length, KF, KM, dt) of a system
    whose ``rollout_kernel`` is ``"quadrotor"``, read from
    :mod:`dcol_tpu_torch.systems.quadrotor`, in the kernel's order."""
    # imported here: the quadrotor's module imports the solver, which
    # imports this one
    from dcol_tpu_torch.systems import quadrotor as quad

    if sys.rollout_kernel != "quadrotor":
        raise ValueError(f"{type(sys).__name__} names rollout kernel "
                         f"{sys.rollout_kernel!r}; this one is the "
                         f"quadrotor's")
    if (sys.nx, sys.nu) != (NX, NU):
        raise ValueError(f"the rollout kernel takes nx={NX}, nu={NU}; the "
                         f"system has nx={sys.nx}, nu={sys.nu}")
    return (float(quad.MASS), *(float(j) for j in quad.J_DIAG),
            float(quad.GRAVITY), float(quad.ARM_L), float(quad.KF),
            float(quad.KM), float(sys.dt))


def _check(tensors: Sequence[torch.Tensor], shapes: Sequence[tuple],
           names: str) -> None:
    names = names.split()
    for name, t, want in zip(names, tensors, shapes):
        if tuple(t.shape) != want:
            raise ValueError(f"{name} must be {want}, got {tuple(t.shape)}")
    dt = tensors[0].dtype
    if dt not in _CTYPE:
        raise TypeError(f"rollout kernel supports float32/float64, got {dt}")
    if any(t.dtype != dt for t in tensors):
        raise TypeError(f"{', '.join(names)} must share one dtype")
    if any(t.device != tensors[0].device for t in tensors):
        raise ValueError(f"{', '.join(names)} must share one device")


def _on_card(tensors: Sequence[torch.Tensor]) -> None:
    if not all(t.is_cuda for t in tensors):
        raise ValueError("the rollout kernel takes CUDA tensors only; CPU "
                         "tensors go to the loop")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` row-major, contiguous and 16-byte aligned (the kernel reads
    rows as 16-byte vectors): ``t`` itself where it already is, else a
    copy (a view that starts inside its storage may be misaligned)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def closed_loop_operands(X, U, K, k, alpha) -> List[torch.Tensor]:
    """The closed loop's operands checked and in the kernel's order
    (X, U, K, k, alpha), each row-major, contiguous and 16-byte aligned:
    the caller's own tensor where it already is, a copy of another."""
    S, N = X.shape[:2]
    C = alpha.shape[-1] if alpha.dim() == 2 else -1
    _check((X, U, K, k, alpha),
           ((S, N, NX), (S, N - 1, NU), (S, N - 1, NU, NX), (S, N - 1, NU),
            (S, C)), "X U K k alpha")
    return [_aligned(t) for t in (X, U, K, k, alpha)]


def open_loop_operands(x0, U) -> List[torch.Tensor]:
    """The open loop's operands checked, contiguous and aligned:
    x0 (S, nx), U (S, N-1, nu)."""
    S = x0.shape[0]
    n = U.shape[1] if U.dim() == 3 else -1
    _check((x0, U), ((S, NX), (S, n, NU)), "x0 U")
    return [_aligned(t) for t in (x0, U)]


def launch_args(sys, x0, x0_stride: int, ops, Xn, Un, S: int, C: int,
                N: int) -> list:
    """The arguments of ``dcol_rollout`` in its order; ``ops`` is
    (X, U, K, k, alpha) with None where the open loop has none."""
    ptr = lambda t: None if t is None else t.data_ptr()
    consts = (ctypes.c_double * 9)(*constants(sys))
    return ([x0.data_ptr(), int(x0_stride)] + [ptr(t) for t in ops]
            + [Xn.data_ptr(), ptr(Un), S, C, N, consts,
               torch.cuda.current_stream(x0.device).cuda_stream])


def _launch(args: list, dtype, what: str) -> None:
    global launches
    rc = _lib(dtype).dcol_rollout(*args)
    if rc != 0:
        raise RuntimeError(f"rollout kernel launch failed: cudaError {rc} "
                           f"({what})")
    with _COUNT_LOCK:
        launches += 1


def rollout_cuda(sys, X, U, K, k, alpha):
    """Closed-loop rollouts on the card for per-scenario candidate step
    sizes alpha (S, C): returns Xn (S, C, N, nx), Un (S, C, N-1, nu), as
    ``altro.rollout_loop``."""
    X, U, K, k, alpha = ops = closed_loop_operands(X, U, K, k, alpha)
    _on_card(ops)
    (S, N), C = X.shape[:2], alpha.shape[1]
    Xn = torch.empty((S, C, N, NX), dtype=X.dtype, device=X.device)
    Un = torch.empty((S, C, N - 1, NU), dtype=X.dtype, device=X.device)
    if S * C > 0:
        _launch(launch_args(sys, X, N * NX, ops, Xn, Un, S, C, N), X.dtype,
                f"S={S}, C={C}, N={N}, {X.dtype}")
    return Xn, Un


def initial_rollout_cuda(sys, x0, U):
    """Open-loop rollout on the card from x0 (S, nx) under U (S, N-1, nu):
    returns X (S, N, nx), as ``altro.initial_rollout_loop``."""
    x0, U = open_loop_operands(x0, U)
    _on_card((x0, U))
    S, N = x0.shape[0], U.shape[1] + 1
    Xn = torch.empty((S, N, NX), dtype=x0.dtype, device=x0.device)
    if S > 0:
        _launch(launch_args(sys, x0, NX, (None, U, None, None, None), Xn,
                            None, S, 1, N), x0.dtype,
                f"open loop, S={S}, N={N}, {x0.dtype}")
    return Xn

"""Wrapper of the hand-written rollout kernel (``csrc/rollout.cu``).

One launch runs a whole rollout of a system that names the kernel (its
``rollout_kernel``: ``"quadrotor"`` or ``"piano_mover"``): the closed loop
of :func:`dcol_tpu_torch.solver.altro.rollout_loop` (``u = U_t - K_t (x -
X_t) - alpha k_t`` and an RK4 step of the system's ``dynamics`` a knot, for
every scenario and candidate step size) or the open loop of
``initial_rollout_loop``, which are its plain versions.  The JAX package
runs the same rollouts as a ``lax.scan``; no Pallas kernel stands behind
them.

The kernel is specialised per (system, dtype) (float32, float64) and
computes in the dtype.  Each specialisation is compiled at first use with
``nvcc`` for ``sm_90a`` into its own shared library with a plain C
interface, cached under ``dcol_tpu_torch/build/`` keyed by a hash of the
source and the flags, and bound with ``ctypes``
(:mod:`dcol_tpu_torch.ops.nvcc_build`).  Nothing is built at import.

A system's constants are read from its module, their one source, and
passed by value at each launch (:func:`constants`): the quadrotor's mass,
inertia, gravity, arm length and rotor coefficients
(:mod:`dcol_tpu_torch.systems.quadrotor`), the piano's control scale
(:mod:`dcol_tpu_torch.systems.piano_mover`), each with the system's
``dt``.  Nothing is copied to the card but the operands the caller holds
there.

While a ``torch.profiler`` records, each launch is noted in
``utils.trace.RECORDER.rollout_launches`` with a pair of CUDA events
around it (no synchronisation).

The wrapper takes CUDA tensors only and raises on anything else: a CPU
tensor, another dtype, a shape it does not take, a system without a
specialisation, a failed build or a launch error.  It never falls back to
the loop.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import List, Sequence, Tuple

import torch

from dcol_tpu_torch.ops import nvcc_build
from dcol_tpu_torch.ops.nvcc_build import Build
from dcol_tpu_torch.utils import trace

SOURCE = os.path.join(nvcc_build.CSRC, "rollout.cu")
# system (a System's rollout_kernel) -> (its struct in rollout.cu, nx, nu,
# the number of constants it is passed)
SYSTEMS = {"quadrotor": ("Quadrotor", 12, 4, 9),
           "piano_mover": ("PianoMover", 6, 3, 2)}

# Kernel launches made by rollout_cuda and initial_rollout_cuda (one per
# call with lanes), counted under a lock: the scenario mesh launches from
# one host thread per device.
launches = 0
_COUNT_LOCK = threading.Lock()

_CTYPE = {torch.float32: "float", torch.float64: "double"}


def _system(system: str) -> tuple:
    if system not in SYSTEMS:
        raise ValueError(f"the rollout kernel has no specialisation for "
                         f"{system!r}; it has {sorted(SYSTEMS)}")
    return SYSTEMS[system]


def build(system: str, dtype) -> Build:
    """Compile (or find in the cache) the kernel for one system and
    dtype."""
    struct = _system(system)[0]
    if dtype not in _CTYPE:
        raise TypeError(f"rollout kernel supports float32/float64, got "
                        f"{dtype}")
    t = _CTYPE[dtype]
    return nvcc_build.build(("rollout", system, dtype), SOURCE,
                            f"rollout_{system}_{t}",
                            [f"-DDCOL_T={t}", f"-DDCOL_SYSTEM={struct}"])


def _lib(system: str, dtype) -> ctypes.CDLL:
    _, nx, nu, n_consts = _system(system)

    def bind(lib: ctypes.CDLL) -> None:
        lib.dcol_rollout_layout.argtypes = [ctypes.POINTER(ctypes.c_int)]
        lib.dcol_rollout_layout.restype = ctypes.c_int
        lib.dcol_rollout.argtypes = (
            [ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 7
            + [ctypes.c_int] * 3
            + [ctypes.POINTER(ctypes.c_double), ctypes.c_void_p])
        lib.dcol_rollout.restype = ctypes.c_int
        got = (ctypes.c_int * 4)()
        lib.dcol_rollout_layout(got)
        want = (torch.finfo(dtype).bits // 8, nx, nu, n_consts)
        if tuple(got) != want:
            raise RuntimeError(f"library {lib._name} was built for "
                               f"{tuple(got)}; expected {want}")

    return nvcc_build.load(build(system, dtype), bind)


def constants(sys) -> Tuple[float, ...]:
    """The constants the kernel of ``sys.rollout_kernel`` is passed, in its
    order: the quadrotor's (mass, J_x, J_y, J_z, gravity, arm length, KF,
    KM, dt) from :mod:`dcol_tpu_torch.systems.quadrotor`, the piano's (dt,
    OMEGA_CONTROL_SCALE) from :mod:`dcol_tpu_torch.systems.piano_mover`."""
    # imported here: the systems' modules import the solver, which imports
    # this one
    from dcol_tpu_torch.systems import piano_mover, quadrotor as quad

    kernel = sys.rollout_kernel
    if kernel not in SYSTEMS:
        raise ValueError(f"{type(sys).__name__} names rollout kernel "
                         f"{kernel!r}; the rollout kernel has "
                         f"{sorted(SYSTEMS)}")
    nx, nu = SYSTEMS[kernel][1:3]
    if (sys.nx, sys.nu) != (nx, nu):
        raise ValueError(f"the {kernel} rollout kernel takes nx={nx}, "
                         f"nu={nu}; the system has nx={sys.nx}, "
                         f"nu={sys.nu}")
    if kernel == "quadrotor":
        return (float(quad.MASS), *(float(j) for j in quad.J_DIAG),
                float(quad.GRAVITY), float(quad.ARM_L), float(quad.KF),
                float(quad.KM), float(sys.dt))
    return (float(sys.dt), float(piano_mover.OMEGA_CONTROL_SCALE))


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
    rows as vectors of up to 16 bytes): ``t`` itself where it already is,
    else a copy (a view that starts inside its storage may be
    misaligned)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def closed_loop_operands(X, U, K, k, alpha,
                         system: str = "quadrotor") -> List[torch.Tensor]:
    """The closed loop's operands of ``system``'s kernel checked and in its
    order (X, U, K, k, alpha), each row-major, contiguous and 16-byte
    aligned: the caller's own tensor where it already is, a copy of
    another."""
    _, nx, nu, _ = _system(system)
    S, N = X.shape[:2]
    C = alpha.shape[-1] if alpha.dim() == 2 else -1
    _check((X, U, K, k, alpha),
           ((S, N, nx), (S, N - 1, nu), (S, N - 1, nu, nx), (S, N - 1, nu),
            (S, C)), "X U K k alpha")
    return [_aligned(t) for t in (X, U, K, k, alpha)]


def open_loop_operands(x0, U, system: str = "quadrotor") -> List[torch.Tensor]:
    """The open loop's operands of ``system``'s kernel checked, contiguous
    and aligned: x0 (S, nx), U (S, N-1, nu)."""
    _, nx, nu, _ = _system(system)
    S = x0.shape[0]
    n = U.shape[1] if U.dim() == 3 else -1
    _check((x0, U), ((S, nx), (S, n, nu)), "x0 U")
    return [_aligned(t) for t in (x0, U)]


def launch_args(sys, x0, x0_stride: int, ops, Xn, Un, S: int, C: int,
                N: int) -> list:
    """The arguments of ``dcol_rollout`` in its order; ``ops`` is
    (X, U, K, k, alpha) with None where the open loop has none."""
    ptr = lambda t: None if t is None else t.data_ptr()
    c = constants(sys)
    return ([x0.data_ptr(), int(x0_stride)] + [ptr(t) for t in ops]
            + [Xn.data_ptr(), ptr(Un), S, C, N, (ctypes.c_double * len(c))(*c),
               torch.cuda.current_stream(x0.device).cuda_stream])


def _launch(sys, args: list, out: torch.Tensor, S: int, C: int, N: int,
            closed: bool) -> None:
    """Launch ``dcol_rollout(*args)`` into ``out``'s dtype and device;
    while a profiler records, note it with CUDA events around it on the
    launch's stream."""
    global launches
    dtype = out.dtype
    lib = _lib(sys.rollout_kernel, dtype)
    note = None
    if trace.recording():
        stream = torch.cuda.current_stream(out.device)
        note = {"system": sys.rollout_kernel, "dtype": str(dtype)[6:],
                "S": S, "C": C, "N": N, "closed": closed,
                "start": torch.cuda.Event(enable_timing=True),
                "end": torch.cuda.Event(enable_timing=True)}
        note["start"].record(stream)
    rc = lib.dcol_rollout(*args)
    if rc != 0:
        raise RuntimeError(
            f"rollout kernel launch failed: cudaError {rc} ("
            f"{sys.rollout_kernel}, {'closed' if closed else 'open'} loop, "
            f"S={S}, C={C}, N={N}, {dtype})")
    if note is not None:
        note["end"].record(stream)
        trace.RECORDER.rollout_launches.append(note)
    with _COUNT_LOCK:
        launches += 1


def rollout_cuda(sys, X, U, K, k, alpha):
    """Closed-loop rollouts on the card for per-scenario candidate step
    sizes alpha (S, C): returns Xn (S, C, N, nx), Un (S, C, N-1, nu), as
    ``altro.rollout_loop``."""
    X, U, K, k, alpha = ops = closed_loop_operands(X, U, K, k, alpha,
                                                   sys.rollout_kernel)
    _on_card(ops)
    (S, N, nx), (C, nu) = X.shape, (alpha.shape[1], U.shape[-1])
    Xn = torch.empty((S, C, N, nx), dtype=X.dtype, device=X.device)
    Un = torch.empty((S, C, N - 1, nu), dtype=X.dtype, device=X.device)
    if S * C > 0:
        _launch(sys, launch_args(sys, X, N * nx, ops, Xn, Un, S, C, N), Xn,
                S, C, N, closed=True)
    return Xn, Un


def initial_rollout_cuda(sys, x0, U):
    """Open-loop rollout on the card from x0 (S, nx) under U (S, N-1, nu):
    returns X (S, N, nx), as ``altro.initial_rollout_loop``."""
    x0, U = open_loop_operands(x0, U, sys.rollout_kernel)
    _on_card((x0, U))
    (S, nx), N = x0.shape, U.shape[1] + 1
    Xn = torch.empty((S, N, nx), dtype=x0.dtype, device=x0.device)
    if S > 0:
        _launch(sys, launch_args(sys, x0, nx, (None, U, None, None, None),
                                 Xn, None, S, 1, N),
                Xn, S, 1, N, closed=False)
    return Xn

"""The rollout kernel's wrapper (``ops/rollout_cuda.py``) and the solver's
dispatch to it, on the CPU with no card and no nvcc, for the quadrotor:
the operands handed to the kernel, the shapes and dtypes it refuses, the
constants it is passed (those of ``systems/quadrotor.py``), the library
names, which systems name a kernel, and rollouts on CPU tensors, which stay
the loop bit for bit.  One test compares the kernel with the loop on a card
and skips here.  The piano mover's are in ``test_torch_rollout_piano.py``."""

import dataclasses
import types

import numpy as np
import pytest
import torch

from dcol_tpu_torch.ops import nvcc_build, rollout_cuda
from dcol_tpu_torch.parallel.batch import perturb_scenarios
from dcol_tpu_torch.solver import altro
from dcol_tpu_torch.systems import cone_through_wall, piano_mover, quadrotor
from dcol_tpu_torch.utils import trace

torch.set_num_threads(1)

F32, F64 = torch.float32, torch.float64
S, C, N = 3, 2, 6


def _closed(dtype=F32, S=S, C=C, N=N, seed=0):
    """(X, U, K, k, alpha) of a closed loop, contiguous, on the CPU."""
    rng = np.random.default_rng(seed)
    T = lambda *s: torch.as_tensor(rng.normal(size=s), dtype=dtype)
    return (T(S, N, 12), T(S, N - 1, 4), 0.05 * T(S, N - 1, 4, 12),
            T(S, N - 1, 4), T(S, C).abs())


@pytest.fixture(scope="module")
def quad():
    """(system, params, X, U, K, k, alpha) of 3 f32 quadrotor scenarios at
    6 knots: rollouts of perturbed initial states, small random gains."""
    sys_, params, X0, U0, _ = quadrotor.make_problem(F32, "cpu", N=N)
    pb, xb, ub = perturb_scenarios(params, X0, U0, n=S, seed=1,
                                   x0_sigma=0.02)
    X = altro.initial_rollout_loop(sys_, pb, xb[:, 0], ub)
    _, _, K, k, alpha = _closed()
    return sys_, pb, X, ub, 0.2 * K, 0.05 * k, alpha


@pytest.mark.parametrize("loop", ["closed", "open"])
def test_contiguous_operands_are_the_callers_tensors(loop):
    """Contiguous, aligned operands reach the kernel as they are: same
    storage, no copy, in the kernel's order."""
    X, U, K, k, alpha = _closed()
    if loop == "closed":
        want = (X, U, K, k, alpha)
        ops = rollout_cuda.closed_loop_operands(*want)
    else:
        want = (X[:, 0].contiguous(), U)
        ops = rollout_cuda.open_loop_operands(*want)
    assert len(ops) == len(want)
    for got, w in zip(ops, want):
        assert got.data_ptr() == w.data_ptr() and got.is_contiguous()


def test_strided_operands_become_contiguous_copies():
    """A strided K and an expanded alpha become contiguous copies with the
    same values; the others stay in place."""
    X, U, K, k, alpha = _closed()
    Kt = K.transpose(-1, -2).contiguous().transpose(-1, -2)
    a = alpha[:1].expand(S, C)
    assert not Kt.is_contiguous() and not a.is_contiguous()
    ops = rollout_cuda.closed_loop_operands(X, U, Kt, k, a)
    assert ops[2].is_contiguous() and ops[2].data_ptr() != Kt.data_ptr()
    assert torch.equal(ops[2], K) and torch.equal(ops[4], a)
    assert ops[4].is_contiguous() and ops[0].data_ptr() == X.data_ptr()


def test_misaligned_operands_become_aligned_copies():
    """A contiguous view that starts 4 bytes into its storage is copied to
    a 16-byte aligned tensor with the same values (the kernel reads rows
    as 16-byte vectors); aligned operands stay in place."""
    X, U, K, k, alpha = _closed()
    flat = torch.empty(X.numel() + 1, dtype=X.dtype)
    Xm = flat[1:].view(X.shape)
    Xm.copy_(X)
    assert Xm.is_contiguous() and Xm.data_ptr() % 16 != 0
    ops = rollout_cuda.closed_loop_operands(Xm, U, K, k, alpha)
    assert ops[0].data_ptr() % 16 == 0 and torch.equal(ops[0], X)
    assert all(o.data_ptr() == t.data_ptr() for o, t in
               zip(ops[1:], (U, K, k, alpha)))
    x0, _ = rollout_cuda.open_loop_operands(Xm[:, 0], U)
    assert x0.data_ptr() % 16 == 0 and torch.equal(x0, X[:, 0])


@pytest.mark.parametrize("bad, match", [
    ("U", "U must be"), ("K", "K must be"), ("k", "k must be"),
    ("alpha", "alpha must be"), ("X", "U must be"),
    ("mixed", "share one dtype"), ("f16", "float32/float64"),
    ("int", "float32/float64"),
])
def test_closed_loop_refuses_shapes_and_dtypes(bad, match):
    """Operands of other shapes than (S, N, 12), (S, N-1, 4),
    (S, N-1, 4, 12), (S, N-1, 4), (S, C), of mixed dtypes or of a dtype
    with no specialisation raise before anything is built."""
    X, U, K, k, alpha = _closed()
    ops = dict(X=X, U=U, K=K, k=k, alpha=alpha)
    if bad in ("U", "K", "k"):
        ops[bad] = ops[bad][:, 1:]
    elif bad == "alpha":
        ops[bad] = alpha[:, 0]
    elif bad == "X":
        ops[bad] = X[:, 1:]
    elif bad == "mixed":
        ops["k"] = k.double()
    else:
        dt = torch.float16 if bad == "f16" else torch.int32
        ops = {n: t.to(dt) for n, t in ops.items()}
    with pytest.raises((ValueError, TypeError), match=match):
        rollout_cuda.closed_loop_operands(**ops)
    assert not any(key[0] == "rollout" for key in nvcc_build._BUILDS)


@pytest.mark.parametrize("which", ["closed", "open"])
def test_cpu_tensors_raise(quad, which):
    """The wrapper takes CUDA tensors only: CPU tensors raise, with no
    build and no launch counted."""
    sys_, _, X, U, K, k, alpha = quad
    n = rollout_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensors only"):
        if which == "closed":
            rollout_cuda.rollout_cuda(sys_, X, U, K, k, alpha)
        else:
            rollout_cuda.initial_rollout_cuda(sys_, X[:, 0], U)
    assert rollout_cuda.launches == n
    assert not any(key[0] == "rollout" for key in nvcc_build._BUILDS)


def test_open_loop_refuses_shapes():
    X, U = _closed()[:2]
    with pytest.raises(ValueError, match="x0 must be"):
        rollout_cuda.open_loop_operands(X[:, 0, :6], U)
    with pytest.raises(ValueError, match="U must be"):
        rollout_cuda.open_loop_operands(X[:, 0], U[..., :3])


def test_constants_are_the_quadrotor_modules(quad):
    """The kernel is passed mass, J, gravity, arm length, KF, KM from
    systems/quadrotor.py and the system's dt, in the kernel's order; the
    piano's kernel its dt and OMEGA_CONTROL_SCALE; the cone names no kernel
    and raises."""
    sys_ = quad[0]
    want = (quadrotor.MASS, *quadrotor.J_DIAG, quadrotor.GRAVITY,
            quadrotor.ARM_L, quadrotor.KF, quadrotor.KM, sys_.dt)
    assert rollout_cuda.constants(sys_) == tuple(float(v) for v in want)
    other = quadrotor.make_system(N=N, dt=0.05)
    assert rollout_cuda.constants(other)[-1] == 0.05
    piano = piano_mover.make_system()
    assert rollout_cuda.constants(piano) == (
        0.1, float(piano_mover.OMEGA_CONTROL_SCALE))
    cone = cone_through_wall.make_system()
    with pytest.raises(ValueError, match="names rollout kernel None"):
        rollout_cuda.constants(cone)


@pytest.mark.parametrize("loop", ["closed", "open"])
def test_launch_args_in_the_kernels_order(quad, loop, monkeypatch):
    """dcol_rollout's arguments: x0 and its stride, X, U, K, k, alpha (None
    in the open loop), Xn, Un, S, C, N, the constants, the stream."""
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=7))
    sys_, _, X, U, K, k, alpha = quad
    if loop == "closed":
        ops = rollout_cuda.closed_loop_operands(X, U, K, k, alpha)
        x0, stride, c = ops[0], N * 12, C
        Xn, Un = torch.empty(S, C, N, 12), torch.empty(S, C, N - 1, 4)
    else:
        x0, U = rollout_cuda.open_loop_operands(X[:, 0].contiguous(), U)
        ops, stride, c = (None, U, None, None, None), 12, 1
        Xn, Un = torch.empty(S, N, 12), None
    args = rollout_cuda.launch_args(sys_, x0, stride, ops, Xn, Un, S, c, N)
    ptr = lambda t: None if t is None else t.data_ptr()
    assert args[:7] == [x0.data_ptr(), stride] + [ptr(t) for t in ops]
    assert args[7:12] == [Xn.data_ptr(), ptr(Un), S, c, N]
    assert tuple(args[12]) == rollout_cuda.constants(sys_)
    assert args[13] == 7


def test_build_names_the_dtype(monkeypatch):
    """One library per (system, dtype), named and defined by both; nothing
    is compiled here, and other dtypes and systems raise."""
    seen = []
    monkeypatch.setattr(rollout_cuda.nvcc_build, "build",
                        lambda *a: seen.append(a) or a)
    for dt in (F32, F64):
        rollout_cuda.build("quadrotor", dt)
    (k1, src, n1, d1), (k2, _, n2, d2) = seen
    assert src == rollout_cuda.SOURCE and src.endswith("csrc/rollout.cu")
    assert (k1, n1, d1) == (("rollout", "quadrotor", F32),
                            "rollout_quadrotor_float",
                            ["-DDCOL_T=float", "-DDCOL_SYSTEM=Quadrotor"])
    assert (k2, n2, d2) == (("rollout", "quadrotor", F64),
                            "rollout_quadrotor_double",
                            ["-DDCOL_T=double", "-DDCOL_SYSTEM=Quadrotor"])
    with pytest.raises(TypeError, match="float32/float64"):
        rollout_cuda.build("quadrotor", torch.bfloat16)
    with pytest.raises(ValueError, match="no specialisation"):
        rollout_cuda.build("coneThroughWall", F32)


@pytest.mark.parametrize("mod, kernel", [
    (quadrotor, "quadrotor"), (piano_mover, "piano_mover"),
    (cone_through_wall, None),
])
def test_systems_name_their_rollout_kernel(mod, kernel):
    """The quadrotor and the piano mover name their kernels; the cone names
    none and keeps the loop on every device; the name is no dataclass
    field."""
    sys_ = mod.make_system()
    assert sys_.rollout_kernel == kernel
    assert "rollout_kernel" not in {f.name
                                    for f in dataclasses.fields(sys_)}
    card = types.SimpleNamespace(is_cuda=True)
    host = types.SimpleNamespace(is_cuda=False)
    assert altro.uses_rollout_kernel(sys_, card) == (kernel is not None)
    assert not altro.uses_rollout_kernel(sys_, host)


@pytest.mark.parametrize("which", ["closed", "open"])
def test_card_tensors_of_the_quadrotor_take_the_kernel(quad, which,
                                                       monkeypatch):
    """altro.rollout and altro.initial_rollout hand a CUDA tensor of the
    quadrotor to the wrapper, with no loop, and the profiled step counts a
    kernel rollout (the tensor stood in for)."""
    sys_ = quad[0]
    calls = []

    def refuse(*a):
        raise AssertionError("the loop ran for a CUDA tensor")
    monkeypatch.setattr(altro, "rollout_loop", refuse)
    monkeypatch.setattr(altro, "initial_rollout_loop", refuse)
    monkeypatch.setattr(rollout_cuda, "rollout_cuda",
                        lambda *a: calls.append(a) or "Xn, Un")
    monkeypatch.setattr(rollout_cuda, "initial_rollout_cuda",
                        lambda *a: calls.append(a) or "X")
    x = types.SimpleNamespace(is_cuda=True)
    trace.RECORDER.clear()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        if which == "closed":
            out = altro.rollout(sys_, {}, x, "U", "K", "k", "alpha")
            assert out == "Xn, Un"
            assert calls == [(sys_, x, "U", "K", "k", "alpha")]
        else:
            assert altro.initial_rollout(sys_, {}, x, "U") == "X"
            assert calls == [(sys_, x, "U")]
    assert trace.RECORDER.rollouts == {"kernel": 1}
    trace.RECORDER.clear()


@pytest.mark.parametrize("system, dtype", [
    ("quadrotor", F32), ("quadrotor", F64), ("piano_mover", F64),
    ("coneThroughWall", F64),
])
def test_cpu_rollouts_are_the_loop(system, dtype, monkeypatch):
    """On CPU tensors altro.rollout and altro.initial_rollout are the loop
    bit for bit, for every system, and never reach the wrapper; a profiled
    step counts them as loop rollouts."""
    mod = {"quadrotor": quadrotor, "piano_mover": piano_mover,
           "coneThroughWall": cone_through_wall}[system]
    sys_, params, X0, U0, _ = mod.make_problem(dtype, "cpu")

    def refuse(*a):
        raise AssertionError("the wrapper was called for CPU tensors")
    monkeypatch.setattr(rollout_cuda, "rollout_cuda", refuse)
    monkeypatch.setattr(rollout_cuda, "initial_rollout_cuda", refuse)
    pb, xb, ub = perturb_scenarios(params, X0, U0, n=2, seed=3,
                                   x0_sigma=0.02)
    rng = np.random.default_rng(4)
    T = lambda *s: torch.as_tensor(rng.normal(size=s), dtype=dtype)
    nx, nu, n = sys_.nx, sys_.nu, sys_.N
    X = altro.initial_rollout_loop(sys_, pb, xb[:, 0], ub)
    K, k = 1e-3 * T(2, n - 1, nu, nx), 1e-2 * T(2, n - 1, nu)
    alpha = torch.tensor([[1.0, 0.5], [0.25, 0.0]], dtype=dtype)
    trace.RECORDER.clear()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        X_d = altro.initial_rollout(sys_, pb, xb[:, 0], ub)
        Xn, Un = altro.rollout(sys_, pb, X, ub, K, k, alpha)
    assert bool(torch.isfinite(Xn).all()) and torch.equal(X_d, X)
    Xl, Ul = altro.rollout_loop(sys_, pb, X, ub, K, k, alpha)
    assert torch.equal(Xn, Xl) and torch.equal(Un, Ul)
    assert Xn.shape == (2, 2, n, nx) and Un.shape == (2, 2, n - 1, nu)
    assert trace.RECORDER.rollouts == {"loop": 2}
    trace.RECORDER.clear()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [F32, F64])
def test_card_kernel_against_the_float64_step(quad, dtype):
    """On a card: every kernel state within portbench's dyn_gap limit
    (2e-5 over 1 + |x|) of the float64 RK4 step from its own previous state
    and control, the open loop the same, and scenario 0 replicated in every
    row bitwise equal to its own lanes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    sys_, pb, X, U, K, k, alpha = (
        t.to("cuda", dtype) if torch.is_tensor(t) else t for t in quad)
    Xk, Uk = rollout_cuda.rollout_cuda(sys_, X, U, K, k, alpha)
    Xo = rollout_cuda.initial_rollout_cuda(sys_, X[:, 0], U)
    d = lambda t: t.double()
    rel = lambda a, b: float(((d(a) - b).abs().amax(-1)
                              / (1.0 + b.abs().amax(-1))).max())
    step = sys_.discrete_dynamics(None, d(Xk[:, :, :-1]), d(Uk))
    assert rel(Xk[:, :, 1:], step) <= 2e-5
    assert torch.equal(Xk[:, :, 0], X[:, None, 0].expand(S, C, 12))
    step_o = sys_.discrete_dynamics(None, d(Xo[:, :-1]), d(U))
    assert rel(Xo[:, 1:], step_o) <= 2e-5
    rep = [t[:1].expand(t.shape).contiguous() for t in (X, U, K, k, alpha)]
    Xr, Ur = rollout_cuda.rollout_cuda(sys_, *rep)
    assert bool((Xr == Xk[:1]).all() & (Ur == Uk[:1]).all())

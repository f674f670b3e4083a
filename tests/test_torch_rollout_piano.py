"""The piano mover's rollouts: the loop on the CPU against the benchmark's
plain reference (``portbench/configs/piano_mover_ref.py``), the rollout
kernel's wrapper for the piano (constants, layout, launch arguments,
refused operands, dispatch, the profiler's note of each launch), and the
benchmark's cell ``piano_plan_4096`` (its files and the reader of
``rollout_roofline``), on the CPU with no card and no nvcc.  Tests marked
``cuda`` run the kernel on a card and skip here."""

import ctypes
import types

import numpy as np
import pytest
import torch

from dcol_tpu_torch.ops import nvcc_build, rollout_cuda
from dcol_tpu_torch.parallel.batch import perturb_scenarios
from dcol_tpu_torch.solver import altro
from dcol_tpu_torch.systems import piano_mover
from dcol_tpu_torch.utils import trace
from portbench.harness import socp
from portbench.harness.registry import Registry

torch.set_num_threads(1)

F32, F64 = torch.float32, torch.float64
S, C, N = 4, 2, 80
CELL = "piano_plan_4096"
# the cell's limit (portbench/limits/piano_plan_4096.json) on a state's gap
# to the float64 RK4 step from its own previous state and control, over
# 1 + |x|: float32 rounding of one step reads ~4e-8, the reference in TF32
# ~4e-5
DYN_GAP = Registry().limits(CELL)["limits"]["dyn_gap"]


def _inputs(dtype, device="cpu", S=S, C=C, N=N, seed=0):
    """(system, params, X, U, K, k, alpha) of S perturbed pianos: the
    initial rollout of their pinned controls, small seeded gains and C
    candidates in (0, 1]."""
    sys_, params, X0, U0, _ = piano_mover.make_problem(dtype, "cpu", N=N)
    pb, xb, ub = perturb_scenarios(params, X0, U0, n=S, seed=seed,
                                   x0_sigma=0.02)
    X = altro.initial_rollout_loop(sys_, pb, xb[:, 0], ub)
    rng = np.random.default_rng(seed + 1)
    T = lambda *s: torch.as_tensor(rng.normal(size=s), dtype=dtype)
    K, k = 0.05 * T(S, N - 1, 3, 6), 0.5 * T(S, N - 1, 3)
    alpha = torch.as_tensor(rng.uniform(0.1, 1.0, (S, C)), dtype=dtype)
    to = lambda t: t.to(device) if torch.is_tensor(t) else t
    return (sys_, {n: to(v) for n, v in pb.items()},
            *(to(t) for t in (X, ub, K, k, alpha)))


def _reference():
    return Registry().reference("piano_mover")


def _gap(Xn, Un, ref):
    """The largest gap of a state to the reference's float64 RK4 step from
    its own previous state and control, over 1 + |x|."""
    X, U = Xn.double(), Un.double()
    step = ref.step(X[..., :-1, :], U, socp.REF)
    return float(((X[..., 1:, :] - step).abs().amax(-1)
                  / (1.0 + step.abs().amax(-1))).max())


@pytest.mark.parametrize("dtype, tol", [(F64, 1e-12), (F32, DYN_GAP)])
@pytest.mark.parametrize("loop", ["closed", "open"])
def test_cpu_rollout_against_the_reference(loop, dtype, tol):
    """The port's piano rollout on the CPU (the loop the kernel must
    match): every state within ``tol`` of the reference's float64 RK4 step
    from its own previous state and control, closed and open loop."""
    sys_, pb, X, U, K, k, alpha = _inputs(dtype)
    ref = _reference()
    if loop == "closed":
        Xn, Un = altro.rollout(sys_, pb, X, U, K, k, alpha)
        assert Xn.shape == (S, C, N, 6) and Un.shape == (S, C, N - 1, 3)
        assert torch.equal(Xn[:, :, 0], X[:, None, 0].expand(S, C, 6))
    else:
        Xn, Un = altro.initial_rollout(sys_, pb, X[:, 0], U), U
        assert Xn.shape == (S, N, 6)
    assert Xn.dtype == dtype and bool(torch.isfinite(Xn).all())
    gap = _gap(Xn, Un, ref)
    assert gap <= tol
    if dtype == F32:
        assert gap > 0.0  # the f32 rounding shows: the comparison has teeth


def test_reference_step_is_the_ports_dynamics():
    """The reference's A x + B u is PianoMover.dynamics: the control scale
    is OMEGA_CONTROL_SCALE, which the configuration states."""
    ref = _reference()
    assert (Registry().config("piano_mover")["plant"]["omega_control_scale"]
            == piano_mover.OMEGA_CONTROL_SCALE)
    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.normal(size=(5, 6)))
    u = torch.as_tensor(rng.normal(size=(5, 3)))
    sys_ = piano_mover.make_system()
    got = sys_.dynamics(None, x, u)
    assert torch.allclose(got, ref.dynamics(x, u, socp.REF), rtol=0,
                          atol=1e-15)
    assert torch.equal(got[:, 5], u[:, 2] / 100.0)


def test_constants_and_layout():
    """The piano's kernel is passed dt and OMEGA_CONTROL_SCALE; its
    library is checked for (itemsize, nx = 6, nu = 3, 2 constants)."""
    sys_ = piano_mover.make_system(dt=0.05)
    assert rollout_cuda.constants(sys_) == (0.05, 100.0)
    assert rollout_cuda.SYSTEMS["piano_mover"] == ("PianoMover", 6, 3, 2)


@pytest.mark.parametrize("layout, ok", [
    ((4, 6, 3, 2), True), ((4, 12, 4, 9), False), ((8, 6, 3, 2), False),
])
def test_library_layout_is_checked(layout, ok, monkeypatch):
    """A loaded library must report the piano's layout in the dtype asked
    for; another system's or dtype's is refused (no nvcc: the build and the
    library are stood in for)."""
    class Fn:
        """A stand-in for a ctypes function: callable, takes argtypes."""

        def __init__(self, fn=None):
            self.fn = fn

        def __call__(self, *a):
            return self.fn(*a)

    def layout_fn(out):
        for i, v in enumerate(layout):
            out[i] = v
        return 0
    lib = types.SimpleNamespace(_name="stand-in", dcol_rollout=Fn(),
                                dcol_rollout_layout=Fn(layout_fn))
    built = []
    monkeypatch.setattr(nvcc_build, "build",
                        lambda *a: built.append(a) or a)
    monkeypatch.setattr(nvcc_build, "load", lambda b, bind: bind(lib) or lib)
    if ok:
        assert rollout_cuda._lib("piano_mover", F32) is lib
    else:
        with pytest.raises(RuntimeError, match="was built for"):
            rollout_cuda._lib("piano_mover", F32)
    assert built[0][0] == ("rollout", "piano_mover", F32)
    assert built[0][2:] == ("rollout_piano_mover_float",
                            ["-DDCOL_T=float", "-DDCOL_SYSTEM=PianoMover"])


@pytest.mark.parametrize("loop", ["closed", "open"])
def test_launch_args_in_the_kernels_order(loop, monkeypatch):
    """dcol_rollout's arguments for the piano: x0 and its stride (N x 6,
    or 6 in the open loop), X, U, K, k, alpha, Xn, Un, S, C, N, its two
    constants, the stream."""
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=9))
    sys_, _, X, U, K, k, alpha = _inputs(F32)
    if loop == "closed":
        ops = rollout_cuda.closed_loop_operands(X, U, K, k, alpha,
                                                "piano_mover")
        x0, stride, c = ops[0], N * 6, C
        Xn, Un = torch.empty(S, C, N, 6), torch.empty(S, C, N - 1, 3)
    else:
        x0, U = rollout_cuda.open_loop_operands(X[:, 0].contiguous(), U,
                                                "piano_mover")
        ops, stride, c = (None, U, None, None, None), 6, 1
        Xn, Un = torch.empty(S, N, 6), None
    args = rollout_cuda.launch_args(sys_, x0, stride, ops, Xn, Un, S, c, N)
    ptr = lambda t: None if t is None else t.data_ptr()
    assert args[:7] == [x0.data_ptr(), stride] + [ptr(t) for t in ops]
    assert args[7:12] == [Xn.data_ptr(), ptr(Un), S, c, N]
    assert isinstance(args[12], ctypes.Array) and len(args[12]) == 2
    assert tuple(args[12]) == (0.1, 100.0)
    assert args[13] == 9


@pytest.mark.parametrize("bad, match", [
    ("quad_shapes", "X must be|U must be"), ("K", "K must be"),
    ("k", "k must be"), ("f16", "float32/float64"), ("int", "float32/float64"),
    ("mixed", "share one dtype"),
])
def test_piano_operands_refuse_shapes_and_dtypes(bad, match):
    """The piano's kernel takes (S, N, 6), (S, N-1, 3), (S, N-1, 3, 6),
    (S, N-1, 3), (S, C) of one float dtype: the quadrotor's nx and nu, other
    shapes, other or mixed dtypes raise before anything is built; so do the
    piano's operands given to the quadrotor's kernel."""
    _, _, X, U, K, k, alpha = _inputs(F32)
    ops = dict(X=X, U=U, K=K, k=k, alpha=alpha)
    if bad == "quad_shapes":
        ops = dict(X=torch.zeros(S, N, 12), U=torch.zeros(S, N - 1, 4),
                   K=torch.zeros(S, N - 1, 4, 12), k=torch.zeros(S, N - 1, 4),
                   alpha=alpha)
    elif bad in ("K", "k"):
        ops[bad] = ops[bad][..., :2]
    elif bad == "mixed":
        ops["K"] = K.double()
    else:
        dt = torch.float16 if bad == "f16" else torch.int32
        ops = {n: t.to(dt) for n, t in ops.items()}
    with pytest.raises((ValueError, TypeError), match=match):
        rollout_cuda.closed_loop_operands(**ops, system="piano_mover")
    # the quadrotor's kernel refuses the piano's operands
    with pytest.raises(ValueError, match="x0 must be"):
        rollout_cuda.open_loop_operands(X[:, 0], U)
    with pytest.raises(ValueError, match="X must be"):
        rollout_cuda.closed_loop_operands(X, U, K, k, alpha)
    assert not any(key[0] == "rollout" for key in nvcc_build._BUILDS)


def test_cpu_tensors_raise():
    """The wrapper takes CUDA tensors only, for the piano too: no build, no
    launch counted."""
    sys_, _, X, U, K, k, alpha = _inputs(F32)
    n = rollout_cuda.launches
    with pytest.raises(ValueError, match="CUDA tensors only"):
        rollout_cuda.rollout_cuda(sys_, X, U, K, k, alpha)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        rollout_cuda.initial_rollout_cuda(sys_, X[:, 0], U)
    assert rollout_cuda.launches == n
    assert not any(key[0] == "rollout" for key in nvcc_build._BUILDS)


@pytest.mark.parametrize("which", ["closed", "open"])
def test_card_tensors_of_the_piano_take_the_kernel(which, monkeypatch):
    """altro.rollout and altro.initial_rollout hand a CUDA tensor of the
    piano to the wrapper, with no loop (the tensor stood in for), and a
    profiled step counts a kernel rollout."""
    sys_ = piano_mover.make_system()
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
            assert altro.rollout(sys_, {}, x, "U", "K", "k", "a") == "Xn, Un"
            assert calls == [(sys_, x, "U", "K", "k", "a")]
        else:
            assert altro.initial_rollout(sys_, {}, x, "U") == "X"
            assert calls == [(sys_, x, "U")]
    assert trace.RECORDER.rollouts == {"kernel": 1}
    trace.RECORDER.clear()


def test_cpu_rollouts_of_the_float32_piano_are_the_loop(monkeypatch):
    """On CPU tensors the f32 piano's rollouts are the loop bit for bit and
    never reach the wrapper."""
    def refuse(*a):
        raise AssertionError("the wrapper was called for CPU tensors")
    monkeypatch.setattr(rollout_cuda, "rollout_cuda", refuse)
    monkeypatch.setattr(rollout_cuda, "initial_rollout_cuda", refuse)
    sys_, pb, X, U, K, k, alpha = _inputs(F32)
    Xn, Un = altro.rollout(sys_, pb, X, U, K, k, alpha)
    Xl, Ul = altro.rollout_loop(sys_, pb, X, U, K, k, alpha)
    assert torch.equal(Xn, Xl) and torch.equal(Un, Ul)
    assert torch.equal(altro.initial_rollout(sys_, pb, X[:, 0], U),
                       altro.initial_rollout_loop(sys_, pb, X[:, 0], U))


class _Stop(Exception):
    pass


class _Event:
    """A stand-in for a timing CUDA event."""

    def __init__(self, enable_timing=False, ms=0.0):
        self.stream, self.ms = None, ms

    def record(self, stream=None):
        self.stream = stream

    def elapsed_time(self, end):
        return end.ms


@pytest.mark.parametrize("profiled", [True, False])
def test_launches_are_noted_under_a_profiler(profiled, monkeypatch):
    """While a profiler records, each launch is noted in
    RECORDER.rollout_launches (system, dtype, S, C, N, closed or open) with
    events recorded on the launch's stream; outside one nothing is noted.
    The library and the card are stood in for."""
    stream = types.SimpleNamespace(cuda_stream=5)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev=None: stream)
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(rollout_cuda, "_on_card", lambda ts: None)
    got = []
    lib = types.SimpleNamespace(dcol_rollout=lambda *a: got.append(a) or 0)
    monkeypatch.setattr(rollout_cuda, "_lib", lambda system, dtype: lib)
    sys_, _, X, U, K, k, alpha = _inputs(F32)
    trace.RECORDER.clear()
    n = rollout_cuda.launches
    ctx = (torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU]) if profiled
        else torch.autograd.profiler.record_function("unprofiled"))
    with ctx:
        rollout_cuda.rollout_cuda(sys_, X, U, K, k, alpha)
        rollout_cuda.initial_rollout_cuda(sys_, X[:, 0], U)
    assert len(got) == 2 and rollout_cuda.launches == n + 2
    notes = trace.RECORDER.rollout_launches
    if not profiled:
        assert notes == []
        return
    keys = [{k_: v for k_, v in d.items() if k_ not in ("start", "end")}
            for d in notes]
    assert keys == [
        dict(system="piano_mover", dtype="float32", S=S, C=C, N=N,
             closed=True),
        dict(system="piano_mover", dtype="float32", S=S, C=1, N=N,
             closed=False)]
    assert all(d["start"].stream is stream and d["end"].stream is stream
               for d in notes)
    trace.RECORDER.clear()
    assert trace.RECORDER.rollout_launches == []


# -- the benchmark's cell ----------------------------------------------------

def test_cell_resolves_its_pieces():
    """piano_plan_4096 names the piano's configuration, the plan mix of
    4096 scenarios, its limits and the plain reference."""
    reg = Registry()
    cell = reg.cell(CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "piano_mover", "plan_b4096", 1)
    cfg = reg.config("piano_mover")
    assert (cfg["N"], cfg["nx"], cfg["nu"], cfg["dt"], cfg["dtype"],
            cfg["tf32"], len(cfg["obstacles"])) == (80, 6, 3, 0.1,
                                                    "float32", False, 3)
    mix = reg.mix("plan_b4096")
    assert (mix["kind"], mix["scenarios"], mix["x0_sigma"], mix["judged"],
            mix["progress_iter"], mix["trace_iter"]) == (
        "plan", 4096, 0.02, 32, 20, 20)
    lim = reg.limits(CELL)["limits"]
    assert set(lim) == {"dyn_gap", "alpha_gap", "alpha_gap_p75", "iter_gap",
                        "violation"}
    assert lim["dyn_gap"] == 1e-6 and lim["iter_gap"] == 0
    ref = reg.reference("piano_mover")
    assert ref.dt == 0.1 and type(ref).__name__ == "Reference"
    bench = [c for c in reg.bench["configs"] if c["name"] == "piano_mover"]
    assert len(bench) == 1 and bench[0]["reduced"] == []


def test_every_metric_of_the_cell_has_a_reader():
    """The cell reports scen_iters_per_s and setup_s end to end, and each
    of its eight per-layer metrics finds its reader."""
    reg = Registry()
    e2e = {m["name"] for m in reg.metrics_of(CELL, "end_to_end")}
    assert e2e == {"scen_iters_per_s", "setup_s"}
    per_layer = reg.metrics_of(CELL, "per_layer")
    assert sorted(m["name"] for m in per_layer) == sorted(
        f"{n}.piano" for n in (
            "host_launches_per_iter", "blocking_syncs_per_iter",
            "pdip_roofline", "device_idle_pct", "pdip_iters_per_problem",
            "solver_syncs_per_iter", "scene_syncs_per_iter",
            "rollout_roofline"))
    for m in per_layer:
        assert m["moves"] == "scen_iters_per_s"
        assert callable(reg.reader(m["name"]).read)


def test_rollout_roofline_without_a_note_reads_nothing(monkeypatch):
    """No launch noted, no trace, or a port without the note (the parent's
    RECORDER): None, not an error."""
    reader = Registry().reader("rollout_roofline.piano")
    trace.RECORDER.clear()
    ctx = {"trace": {"busy_s": 1.0, "iters": 1}}
    assert reader.read(ctx) is None
    assert reader.read({"trace": None}) is None
    monkeypatch.delattr(trace.RECORDER, "rollout_launches")
    assert reader.read(ctx) is None


def test_rollout_roofline_on_synthetic_notes(monkeypatch):
    """On two noted launches the share is their summed bound over their
    summed event time, the bound counted by hand: bytes at 3.35 TB/s."""
    reader = Registry().reader("rollout_roofline.piano")
    S_, N_ = 4096, 80
    closed = dict(system="piano_mover", dtype="float32", S=S_, C=4, N=N_,
                  closed=True, start=_Event(), end=_Event(ms=0.2))
    opened = dict(system="piano_mover", dtype="float32", S=S_, C=1, N=N_,
                  closed=False, start=_Event(), end=_Event(ms=0.05))
    trace.RECORDER.clear()
    trace.RECORDER.rollout_launches.extend([closed, opened])
    # closed: X (S, N, 6), U and k (S, N-1, 3), K (S, N-1, 3, 6), alpha
    # (S, 4) read; Xn (S, 4, N, 6), Un (S, 4, N-1, 3) written; float32
    b_closed = 4 * (S_ * N_ * 6 + S_ * (N_ - 1) * (3 + 3 + 18) + S_ * 4
                    + S_ * 4 * (N_ * 6 + (N_ - 1) * 3))
    assert b_closed == 85_983_232
    # open: x0 (S, 6) and U read, X (S, N, 6) written
    b_open = 4 * (S_ * 6 + S_ * (N_ - 1) * 3 + S_ * N_ * 6)
    # FLOPs a lane's knot: RK4 4 x 1 + 17 x 6 = 106, the law 3 x 21 = 63;
    # both launches lie under their byte bound at 67 TFLOP/s
    assert S_ * 4 * (N_ - 1) * 169 / 67e12 < b_closed / 3.35e12
    want = 100.0 * (b_closed + b_open) / 3.35e12 / 0.25e-3
    got = reader.read({"trace": {"busy_s": 1.0, "iters": 1}})
    trace.RECORDER.clear()
    assert got == pytest.approx(want, rel=1e-12)
    assert 0.0 < got <= 100.0


# -- on a card ---------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [F32, F64])
@pytest.mark.parametrize("C_", [1, 4])
def test_card_kernel_against_the_step_and_the_reference(dtype, C_):
    """On a card at the cell's size (S = 4096, N = 80): every kernel state
    within the cell's dyn_gap of the float64 RK4 step of the port and of
    the reference from its own previous state and control, the open loop
    the same, and scenario 0 replicated in every row bitwise equal to its
    own lanes."""
    _card()
    sys_, pb, X, U, K, k, alpha = _inputs(dtype, "cuda", S=4096, C=C_)
    ref = _reference()
    Xk, Uk = rollout_cuda.rollout_cuda(sys_, X, U, K, k, alpha)
    Xo = rollout_cuda.initial_rollout_cuda(sys_, X[:, 0], U)
    d = lambda t: t.double()
    rel = lambda a, b: float(((d(a) - b).abs().amax(-1)
                              / (1.0 + b.abs().amax(-1))).max())
    step = sys_.discrete_dynamics(None, d(Xk[:, :, :-1]), d(Uk))
    assert rel(Xk[:, :, 1:], step) <= DYN_GAP
    assert _gap(Xk, Uk, ref) <= DYN_GAP and _gap(Xo, U, ref) <= DYN_GAP
    assert torch.equal(Xk[:, :, 0], X[:, None, 0].expand(4096, C_, 6))
    rep = [t[:1].expand(t.shape).contiguous() for t in (X, U, K, k, alpha)]
    Xr, Ur = rollout_cuda.rollout_cuda(sys_, *rep)
    assert bool((Xr == Xk[:1]).all() & (Ur == Uk[:1]).all())


@pytest.mark.cuda
def test_card_step_under_a_profiler_counts_kernel_rollouts():
    """An ALTRO iteration of 8 f32 pianos on a card, profiled: every
    rollout is a kernel launch, none the loop, each noted with its
    events."""
    _card()
    sys_, params, X0, U0, cfg = piano_mover.make_problem(F32, "cuda")
    pb, xb, ub = perturb_scenarios(params, X0, U0, n=8, seed=0,
                                   x0_sigma=0.02)
    st = altro.make_initial_state(sys_, pb, cfg, xb, ub)

    def stop(itr, st):
        raise _Stop()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]):
        with pytest.raises(_Stop):
            altro.iterate(sys_, pb, cfg, st, callback=stop)
    torch.cuda.synchronize()
    counts = dict(trace.RECORDER.rollouts)
    notes = list(trace.RECORDER.rollout_launches)
    trace.RECORDER.clear()
    assert counts.get("loop", 0) == 0 and counts.get("kernel", 0) >= 1
    assert len(notes) == counts["kernel"]
    assert all(n["system"] == "piano_mover" and n["S"] == 8 for n in notes)
    assert all(n["start"].elapsed_time(n["end"]) > 0 for n in notes)


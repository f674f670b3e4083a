"""Port roofline tool and FMA probe vs the JAX package's tools/roofline.py
(on the CPU): the dispatch-mode FLOP tally against ``jaxpr_flops`` on toy
functions, the per-problem PDIP work against the TPU kernel's per-iteration
instruction count, and the FMA probe's plain version against the closed
form."""

import importlib.util
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dcol_tpu.ops.cones import ConeLayout as JLayout
from dcol_tpu_torch.ops import fma_peak, nvcc_build
from dcol_tpu_torch.ops.cones import ConeLayout
from dcol_tpu_torch.systems import quadrotor
from dcol_tpu_torch.tools import roofline

torch.set_num_threads(1)

_spec = importlib.util.spec_from_file_location(
    "jax_roofline", os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", "roofline.py"))
jroof = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jroof)

_rng = np.random.default_rng(0)
_X, _Y = _rng.normal(size=(4, 5)), _rng.normal(size=(4, 5))
_A, _B = _rng.normal(size=(3, 4, 5)), _rng.normal(size=(3, 5, 6))

TOYS = {
    "elementwise": (lambda a, b: jnp.sin(a * b + a) - b,
                    lambda a, b: torch.sin(a * b + a) - b, (_X, _Y)),
    "batched_matmul": (lambda a, b: a @ b, lambda a, b: a @ b, (_A, _B)),
    "sum": (lambda a: jnp.sum(a, axis=-1), lambda a: torch.sum(a, dim=-1),
            (_X,)),
    "reshape": (lambda a: a.reshape(5, 4).T, lambda a: a.reshape(5, 4).T,
                (_X,)),
}


@pytest.mark.parametrize("toy", sorted(TOYS))
def test_tally_matches_jaxpr_flops(toy):
    """The dispatch-mode tally applies jaxpr_flops's rules exactly:
    elementwise = output elements, matmul = 2mnk, reduction = input
    elements, reshape/transpose = 0."""
    jfn, tfn, args = TOYS[toy]
    want = jroof.jaxpr_flops(jfn, *args)
    got = roofline.tally_flops(tfn, *[torch.tensor(a) for a in args])
    assert got == want
    assert {"elementwise": 80, "batched_matmul": 720, "sum": 20,
            "reshape": 0}[toy] == want


@pytest.mark.parametrize("layout", [(5, 4, 4, 4), (4, 12, 0, 0)])
def test_pdip_work_independent_of_batch(layout):
    """Per-problem (init, per-iteration) FLOPs are the same at B=1 (where
    pdip_work takes them) and B=8: the tally of a solve is linear in B."""
    nv, n_ort, s1, s2 = layout
    lay = ConeLayout(n_ort, s1, s2)
    one = roofline.pdip_work(nv, lay, torch.float32)
    tally = {it: roofline.solve_flops(nv, lay, torch.float32, 8, it) / 8
             for it in (1, 2)}
    assert one == (2 * tally[1] - tally[2], tally[2] - tally[1])
    assert one[0] > 0 and one[1] > 0


def test_pdip_work_tracks_kernel_instruction_count():
    """For each quadrotor group the plain solve's FLOPs per iteration lie
    within [1.0, 1.4] x the TPU kernel's vector instructions per iteration
    and lane (count_kernel_iteration, traced on the CPU).  The two count
    the same Mehrotra iteration in two formulations: measured 1.17-1.21,
    the plain version's matrix products at 2mnk against the kernel's
    unrolled loops."""
    sys_ = quadrotor.make_system()
    for pl, idx in sys_.scene.groups:
        per_iter = roofline.pdip_work(pl.nv, ConeLayout(pl.n_ort, pl.s1,
                                                        pl.s2))[1]
        instr, _, _ = jroof.count_kernel_iteration(
            JLayout(pl.n_ort, pl.s1, pl.s2), pl.nv)
        assert 1.0 <= per_iter / instr <= 1.4, (idx, per_iter, instr)


def test_analyze_covers_every_group():
    rows = roofline.analyze(out=lambda *a: None)
    got = [(r["system"], r["nv"], r["n_ort"], r["s1"], r["s2"])
           for r in rows["groups"]]
    assert got == [("quadrotor", 5, 4, 4, 4), ("quadrotor", 5, 2, 4, 4),
                   ("quadrotor", 4, 0, 4, 4), ("quadrotor", 4, 1, 4, 3),
                   ("quadrotor", 4, 8, 4, 0), ("quadrotor", 6, 5, 4, 4),
                   ("quadrotor", 4, 6, 4, 0), ("piano", 4, 12, 0, 0),
                   ("cone", 4, 7, 3, 0)]
    m = rows["member"]
    assert m["N"] == 100
    assert m["dynamics_jacobians"] > 10 * m["initial_rollout"] > 0


@pytest.mark.parametrize("case", [
    (5, (4, 4, 4), torch.float32, False, False, 429),
    (5, (4, 4, 4), torch.float32, True, True, 546),
    (5, (4, 4, 4), torch.float64, False, False, 853),
    (4, (12, 0, 0), torch.float32, True, False, 4 * (92 + 28) + 5),
    (5, (4, 4, 4), torch.float32, "skipped", True, 4 * (29 + 29) + 6),
])
def test_pdip_bytes(case):
    """Bytes read once and written once per problem: c, G, h (+ warm x, s,
    z, + the skip flag) in, x, s, z, iters (int32), converged (bool) out; a
    skipped problem reads the warm x, s, z and its flag, not c, G or h."""
    nv, lay, dtype, warm, skip, want = case
    kw = (dict(skipped=True) if warm == "skipped"
          else dict(warm=warm, skip=skip))
    assert roofline.pdip_bytes(nv, ConeLayout(*lay), dtype, **kw) == want


def test_account_counts_skipped_problems_apart():
    """A warm launch with a skip mask: its skipped problems move the
    skipped bytes, the others the warm+skip bytes; the work is init for
    every problem plus the iterations run."""
    lay, B, f32 = ConeLayout(4, 4, 4), 10, torch.float32
    row = roofline.account(5, lay, "warm+skip", B, 1.0, 5.0, n_skip=6)
    assert row["bytes"] == 4 * 546 + 6 * roofline.pdip_bytes(
        5, lay, f32, skipped=True) == 4 * 546 + 6 * 238
    init, per_iter = roofline.pdip_work(5, lay, f32, warm=True)
    assert row["flops"] == B * init + 5.0 * per_iter
    assert row["bound_by"] == "bytes" and row["skipped"] == 6
    e = dict(shape="c", obstacles=[0], nv=5, lay=lay, c=torch.zeros(B, 5),
             warm=(None,) * 3, skip=torch.arange(B) < 6)
    assert roofline.account_entry(e, 1.0, 5.0) == dict(
        row, shape="c", obstacles=[0])
    assert [roofline.start_of(w, s) for w, s in (
        (None, None), (e["warm"], None), (e["warm"], e["skip"]))] == [
        "cold", "warm", "warm+skip"]


@pytest.mark.parametrize("layout, arith", [((5, (4, 4, 4)), torch.float64),
                                           ((4, (12, 0, 0)), torch.float32)])
def test_account_bounds_by_arithmetic_type(layout, arith):
    """The bound is the function's, float32 operations and float32 bytes,
    whatever the kernel iterates in.  Beside it the kernel's ceiling takes
    the same work at the peak of the type the launch iterates in: float64
    for a float32 launch with an SOC block, float32 without one."""
    nv, lay = layout[0], ConeLayout(*layout[1])
    f32, B, iters = torch.float32, 25_600, 25_600 * 10.0
    row = roofline.account(nv, lay, "cold", B, 1.0, iters)
    assert row["arith"] == str(arith)[6:]
    assert row["bytes"] == B * roofline.pdip_bytes(nv, lay, f32)
    init, per_iter = roofline.pdip_work(nv, lay, f32)
    assert row["flops"] == B * init + iters * per_iter
    t_bytes = row["bytes"] / roofline.PEAK_BYTES
    for key, dtype in (("bound_ms", f32), ("arith_bound_ms", arith)):
        t_ops = row["flops"] / roofline.PEAK_FLOPS[dtype]
        assert t_ops > t_bytes
        assert row[key] == pytest.approx(1e3 * t_ops)
    assert row["bound_by"] == "operations"
    assert row["of_bound"] == pytest.approx(row["bound_ms"])
    assert row["of_arith_bound"] == pytest.approx(row["arith_bound_ms"])
    as_f32 = roofline.account(nv, lay, "cold", B, 1.0, iters, arith=f32)
    assert as_f32["bound_ms"] == row["bound_ms"]
    assert as_f32["arith_bound_ms"] == as_f32["bound_ms"]
    assert row["arith_bound_ms"] / row["bound_ms"] == pytest.approx(
        roofline.PEAK_FLOPS[f32] / roofline.PEAK_FLOPS[arith])
    tot = roofline.shape_totals([row, as_f32])
    assert tot["arith_bound_ms"] == pytest.approx(
        row["arith_bound_ms"] + as_f32["arith_bound_ms"])
    assert tot["of_arith_bound"] == pytest.approx(tot["arith_bound_ms"] / 2)


def test_bits_entries_are_unchanged_specialisations(monkeypatch):
    """The launches ``ab`` compares bit for bit are of specialisations that
    iterate in their operands' type (the float32 piano, the float64 piano
    and cone): each near-contact batch cold, warm from the plain version's
    cold optimum with G and h moved, and warm with even problems skipped."""
    from dcol_tpu_torch.ops import pdip_cuda

    monkeypatch.setattr(roofline, "BITS_SCENARIOS", 2)
    ents = roofline.bits_entries("cpu")
    # one obstacle group each, at the rollout and the midpoint, 3 starts
    assert len(ents) == 3 * 2 * len(roofline.BITS_SYSTEMS)
    for e in ents:
        dt = e["c"].dtype
        assert pdip_cuda.arith_dtype(dt, e["lay"]) == dt, e["name"]
        assert e["G"].dtype == e["h"].dtype == dt
    assert {str(e["c"].dtype)[6:] + str(e["lay"].s1 + e["lay"].s2 > 0)
            for e in ents} == {"float32False", "float64False", "float64True"}
    for cold, warm, skip in zip(ents[::3], ents[1::3], ents[2::3]):
        assert cold["name"].endswith(" cold") and cold["warm"] is None
        assert warm["name"] == cold["name"][:-4] + "warm"
        torch.testing.assert_close(warm["G"], cold["G"] * (1 + 1e-3))
        assert skip["warm"] is warm["warm"] and skip["skip"] is not None
        assert skip["skip"].tolist() == [
            i % 2 == 0 for i in range(cold["c"].shape[0])]


def test_bound_takes_the_larger_term():
    f32, f64 = torch.float32, torch.float64
    assert roofline.bound_seconds(67e12, 1.0, f32) == (1.0, "operations")
    assert roofline.bound_seconds(1.0, 3.35e12, f32) == (1.0, "bytes")
    assert roofline.bound_seconds(34e12, 3.35e12 / 2, f64) == (
        1.0, "operations")
    t, by = roofline.bound_seconds(2185e6, 25e6, f32)
    assert by == "operations" and t == pytest.approx(32.6e-6, rel=1e-3)


def test_pdip_work_warm_start():
    """A warm start costs far less than the cold least-squares start and
    the same per iteration."""
    lay = ConeLayout(4, 4, 4)
    cold, warm = (roofline.pdip_work(5, lay, torch.float32, w)
                  for w in (False, True))
    assert warm[1] == cold[1] == 3843.0
    assert cold[0] == 1351.0 and 0 < warm[0] < cold[0] / 4


def _probe_input(dtype, L=256):
    rng = np.random.default_rng(1)
    x = np.concatenate([rng.uniform(0.5, 1.0, (8, L)),
                        rng.uniform(0.99, 0.9999, (1, L)),
                        rng.uniform(1e-3, 1e-2, (1, L))])
    return torch.tensor(x, dtype=dtype)


@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-12),
                                        (torch.float32, 1e-4)])
def test_fma_chains_matches_closed_form(dtype, rtol):
    """The plain probe, a b^n + c (1 - b^n) / (1 - b) per chain with
    n = 8 inner: 1e-12 relative in f64 and 1e-4 in f32 (1,600 roundings
    of a contracting recurrence), on random lanes and on the JAX tool's
    constant 0.9999."""
    for x in (_probe_input(dtype), torch.full((10, 64), 0.9999, dtype=dtype)):
        got = fma_peak.fma_chains(x, 200)
        want = fma_peak.closed_form(x, 200)
        assert got.dtype == dtype and got.shape == (x.shape[1],)
        np.testing.assert_allclose(got.double().numpy(), want.numpy(),
                                   rtol=rtol, atol=0)


def test_card_paths_refuse_cpu_without_building():
    """No fallback: the kernel's wrapper and the card commands raise on the
    CPU before anything is built."""
    x = _probe_input(torch.float32)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        fma_peak.fma_chains_cuda(x)
    with pytest.raises(TypeError, match="float32/float64"):
        fma_peak.fma_chains_cuda(x.half())
    with pytest.raises(RuntimeError, match="needs CUDA"):
        roofline.peak(device="cpu")
    with pytest.raises(RuntimeError, match="needs CUDA"):
        roofline.kernel(1e12, device="cpu")
    with pytest.raises(RuntimeError, match="needs CUDA"):
        roofline.ab(".", device="cpu")
    with pytest.raises(RuntimeError, match="needs CUDA"):
        roofline.main_path_pdip(device="cpu")
    assert not any(k[0] == "fma_peak" for k in nvcc_build._BUILDS)


@pytest.mark.cuda
def test_fma_kernel_matches_plain_on_card():
    """Kernel vs plain version and closed form on the card (skips without
    one); 64 FMAs per pass in the SASS."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    for dtype, rtol in ((torch.float64, 1e-12), (torch.float32, 1e-4)):
        x = _probe_input(dtype).cuda()
        n0 = fma_peak.launches
        got = fma_peak.fma_chains_cuda(x, 200)
        assert fma_peak.launches == n0 + 1
        np.testing.assert_allclose(got.double().cpu().numpy(),
                                   fma_peak.closed_form(x, 200).cpu().numpy(),
                                   rtol=rtol, atol=0)
        assert fma_peak.sass_fma_count(dtype)[0] == fma_peak.FMAS_PER_PASS

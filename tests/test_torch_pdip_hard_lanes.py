"""Hard lanes of the PDIP solver.

The near-contact fixture ``tests/torch_fixtures/pdip_near_contact_f32.npz``
is a whole cold constraint batch of the f32 quadrotor, as the card computed
it: obstacle group (1, 7) (nv 5, two orthant rows, SOC 4/4), B = 200, at the
solved trajectory of ``perturb_scenarios(n=1, seed=9, x0_sigma=0.02)``
(``chip_smoke.py``'s latency phase), with tol 2e-5, jitter 1e-6 and 30
iterations.  Its far lane (162) lies near contact.  On the CPU the port's
plain version, JAX's ``solve_socp`` and JAX's Pallas kernel in interpret
mode are held to each other and to an f64 solve on that lane; on the card
the kernel must end it near tol (mu < 10 tol) with alpha within 1e-4 of
the f64 solve's, alone and in its place in the batch (the per-lane rule of
tools/hard_lanes.py; tests/test_torch_lane_rule.py).

NaN isolation inside one kernel launch: a poisoned member (its c or its G)
ends not converged, and every other member comes out bitwise as in the same
launch without the poison, also members whose team shares its warp.

On the card the kernel also meets the rule of each dtype
(``hard_lanes.judge``) on the piano's and the cone's near-contact batches
at their initial rollouts.
"""

import numpy as np
import pytest
import torch

from dcol_tpu.ops.cones import ConeLayout as JLayout
from dcol_tpu.ops.pdip import solve_socp as jax_solve
from dcol_tpu.ops.pdip_pallas import solve_socp_pallas
from dcol_tpu_torch.ops import pdip_cuda
from dcol_tpu_torch.ops.cones import ConeLayout
from dcol_tpu_torch.ops.pdip import solve_socp
from dcol_tpu_torch.solver import altro
from dcol_tpu_torch.tools import hard_lanes
from tests.test_pdip_pallas import _padded_batch

torch.set_num_threads(1)

# two f32 solvers round differently (CPU against card, one summation order
# against another): where their converged flags differ, both must still end
# borderline, at mu < 10 tol, within 2 iterations of each other, and with
# alpha = x[3] within the f32 tolerance of tests/test_pdip_pallas.py:58 of
# the f64 solve
BORDER = 10
ITERS_SLACK = 2
A_RTOL = A_ATOL = 2e-3
# on the far lane every f32 solver must converge (mu < tol) in FAR_ITERS
# +- ITERS_SLACK steps, with alpha within ALPHA_ATOL of the f64 solve: the
# parent kernel's stop missed it by 2.8e-5, the CPU solvers by about 3e-6
FAR_ITERS = 11
ALPHA_ATOL = 1e-4


def _fixture():
    f = np.load(hard_lanes.FIXTURE)
    lay = ConeLayout(*(int(v) for v in f["layout"]))
    kw = dict(tol=float(f["tol"]), max_iters=int(f["max_iters"]),
              jitter=float(f["jitter"]))
    return f["c"], f["G"], f["h"], lay, kw, int(f["far_lanes"][0])


def _alpha_f64(c, G, h, lay, lane):
    out = solve_socp(*(torch.as_tensor(a[lane:lane + 1]).double()
                       for a in (c, G, h)), lay, tol=1e-9, max_iters=40)
    assert bool(out.converged[0])
    return float(out.x[0, 3])


def _mu(s, z, lay, i):
    return float((np.asarray(s)[i].astype(np.float64)
                  * np.asarray(z)[i]).sum()) / lay.degree


def test_fixture_is_the_captured_batch():
    c, G, h, lay, kw, lane = _fixture()
    assert c.dtype == G.dtype == h.dtype == np.float32
    assert (c.shape, G.shape, h.shape) == ((200, 5), (200, 10, 5), (200, 10))
    assert (lay, lane) == (ConeLayout(2, 4, 4), 162)
    assert kw == dict(tol=2e-5, max_iters=30, jitter=1e-6)


@pytest.mark.parametrize("where", ["alone", "in_place"])
def test_fixture_plain_matches_jax(where):
    """The port's plain f32 version against JAX's solve_socp f32 on the far
    lane, run alone (B = 1) and in its place in the batch.  Both converge
    there in 11 iterations on the CPU."""
    c, G, h, lay, kw, lane = _fixture()
    sel, i = ((slice(lane, lane + 1), 0) if where == "alone"
              else (slice(None), lane))
    got = solve_socp(*(torch.as_tensor(a[sel]) for a in (c, G, h)), lay, **kw)
    want = jax_solve(c[sel], G[sel], h[sel],
                     JLayout(lay.n_ort, lay.s1, lay.s2), **kw)
    a64 = _alpha_f64(c, G, h, lay, lane)
    conv = (bool(got.converged[i]), bool(np.asarray(want.converged)[i]))
    mus = (_mu(got.s, got.z, lay, i), _mu(want.s, want.z, lay, i))
    if conv[0] != conv[1]:
        assert max(mus) < BORDER * kw["tol"], (conv, mus)
    iters = (int(got.iters[i]), int(np.asarray(want.iters)[i]))
    assert abs(iters[0] - iters[1]) <= ITERS_SLACK
    alphas = (float(got.x[i, 3]), float(np.asarray(want.x)[i, 3]))
    for alpha in alphas:
        assert abs(alpha - a64) <= A_ATOL + A_RTOL * abs(a64)
    # and on this lane each converges, as the card's kernel must
    assert conv == (True, True) and max(mus) < kw["tol"], (conv, mus)
    for it, alpha in zip(iters, alphas):
        assert abs(it - FAR_ITERS) <= ITERS_SLACK, iters
        assert abs(alpha - a64) <= ALPHA_ATOL, (alphas, a64)


def test_fixture_pallas_interpret():
    """JAX's Pallas kernel in interpret mode (its algebraic form: the scaled
    Gram and the inverse scaling, as tests/test_pdip_pallas.py:42 runs it)
    on the far lane alone.  Recorded on the CPU: converged in 11
    iterations, mu 1.93e-6, alpha 17.8429012 against the f64 17.8428982."""
    c, G, h, lay, kw, lane = _fixture()
    sel = slice(lane, lane + 1)
    out = solve_socp_pallas(c[sel], G[sel], h[sel],
                            JLayout(lay.n_ort, lay.s1, lay.s2), **kw,
                            block=128, interpret=True)
    assert bool(np.asarray(out.converged)[0])
    assert _mu(out.s, out.z, lay, 0) < kw["tol"]
    assert abs(int(np.asarray(out.iters)[0]) - FAR_ITERS) <= ITERS_SLACK
    a64 = _alpha_f64(c, G, h, lay, lane)
    assert abs(float(np.asarray(out.x)[0, 3]) - a64) <= ALPHA_ATOL


def test_hard_lanes_tool_on_cpu():
    """tools/hard_lanes.py's trace and comparison, with the plain version in
    place of the kernel: the far lane converges in 11 steps alone and in
    place, and the plain version against itself has no far lane.  Its
    measurement needs the card and raises without one."""
    fx = hard_lanes.load_fixture("cpu")
    traces = hard_lanes.fixture_traces(solve_socp, fx)
    for t in traces.values():
        assert t["end"].startswith("converged in 11 steps"), t["end"]
        assert [r[0] for r in t["rows"]] == list(range(1, 31))
        assert [r[1] for r in t["rows"]] == list(range(1, 12)) + [11] * 19
    batch = {k: fx[k] for k in ("c", "G", "h", "lay", "kw")}
    o = solve_socp(fx["c"], fx["G"], fx["h"], fx["lay"], **fx["kw"])
    out = {"converged": o.converged, "mu": hard_lanes.mu_of(o, fx["lay"]),
           "alpha": o.x[:, 3]}
    tot = hard_lanes.compare([dict(batch, name="fixture")], [out],
                             [out])["totals"]
    assert tot["kernel_only_far"] == tot["plain_only_far"] == 0
    assert tot["conv_kernel"] == tot["conv_plain"] == int(o.converged.sum())
    with pytest.raises(RuntimeError, match="needs CUDA"):
        hard_lanes.run(device="cpu")


def test_near_contact_batches_on_cpu():
    """The main path's near-contact batches, built here from one scenario's
    initial trajectory (no solve): one flat cold batch per obstacle group
    at the trajectory and one at the midpoint, with the system's settings;
    the plain version against itself on the first has no far lane."""
    from dcol_tpu_torch.parallel.batch import perturb_scenarios
    from dcol_tpu_torch.systems import quadrotor

    sys_, params, X0, U0, _ = quadrotor.make_problem(torch.float32, "cpu")
    pb, xb, _ = perturb_scenarios(params, X0, U0, n=1, seed=0, x0_sigma=0.02)
    batches = hard_lanes.near_contact_batches(sys_, pb, xb, xb)
    groups = [idx for _, idx in sys_.scene.groups]
    assert [b["name"] for b in batches] == (
        [f"solved {idx}" for idx in groups]
        + [f"midpoint {idx}" for idx in groups])
    opts = sys_.scene.opts
    for b in batches:
        B, nr, nv = b["G"].shape
        assert (nv, nr) == (b["nv"], b["lay"].nr)
        assert b["c"].shape == (B, nv) and b["h"].shape == (B, nr)
        assert b["kw"] == dict(tol=opts.tol, max_iters=opts.max_iters,
                               jitter=opts.jitter)
    assert torch.equal(batches[0]["G"], batches[len(groups)]["G"])
    out = hard_lanes.outputs(solve_socp, batches[:1])
    tot = hard_lanes.compare(batches[:1], out, out)["totals"]
    assert tot["kernel_only_far"] == tot["plain_only_far"] == 0
    assert tot["problems"] == batches[0]["c"].shape[0]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("where", ["alone", "in_place"])
def test_fixture_kernel_converges_on_card(where):
    """The kernel ends the far lane near tol (mu < 10 tol: where a lane
    ends below that is rounding; the fault stopped at 80 tol), alone and
    in its place in the batch, with alpha within 1e-4 of the f64 solve."""
    dev = _card()
    c, G, h, lay, kw, lane = _fixture()
    sel, i = ((slice(lane, lane + 1), 0) if where == "alone"
              else (slice(None), lane))
    out = pdip_cuda.solve_socp_cuda(
        *(torch.as_tensor(a[sel]).to(dev) for a in (c, G, h)), lay, **kw)
    assert _mu(out.s.cpu(), out.z.cpu(), lay, i) < BORDER * kw["tol"]
    a64 = _alpha_f64(c, G, h, lay, lane)
    assert abs(float(out.x[i, 3]) - a64) <= ALPHA_ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("start", ["cold", "warm", "warm+skip"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_nan_member_isolated_in_launch_on_card(dtype, start):
    """Members 1 and 9 of 36 (the golden batch tiled 6 times), each with a
    NaN c in one launch and a NaN G in another: member 9's team shares its
    warp with 3 healthy teams of 8 lanes (the layout has an SOC block, so
    f32 operands are iterated in f64, with f64's teams).
    The skipped members (index 2 mod 3) are neither."""
    dev = _card()
    c, G, h, jlay, _ = _padded_batch()
    reps = 6
    c, G, h = (np.concatenate([a] * reps) for a in (c, G, h))
    lay = ConeLayout(jlay.n_ort, jlay.s1, jlay.s2)
    kw = (dict(tol=1e-9, max_iters=40) if dtype == torch.float64
          else dict(tol=2e-5, max_iters=40, jitter=1e-6))
    T = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
    c, G, h = T(c), T(G), T(h)
    extra = {}
    if start != "cold":
        base = solve_socp(c, G, h, lay, **kw)
        extra["warm"] = (base.x, base.s, base.z)
        G, h = G * (1 + 1e-3), h * (1 + 1e-3)
    if start == "warm+skip":
        extra["skip"] = torch.arange(c.shape[0], device=dev) % 3 == 2
    clean = pdip_cuda.solve_socp_cuda(c, G, h, lay, **kw, **extra)
    solved = ~extra.get("skip", torch.zeros_like(clean.converged))
    assert bool(clean.converged[solved].all())
    for member in (1, 9):
        for name in ("c", "G"):
            cp, Gp = c.clone(), G.clone()
            (cp if name == "c" else Gp)[member] = float("nan")
            out = pdip_cuda.solve_socp_cuda(cp, Gp, h, lay, **kw, **extra)
            assert not bool(out.converged[member]), (member, name)
            keep = torch.arange(c.shape[0], device=dev) != member
            for a, b in zip(out, clean):
                assert torch.equal(a[keep], b[keep]), (member, name)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("system", ["piano_mover", "coneThroughWall"])
def test_system_near_contact_batches_on_card(system, dtype):
    """The kernel against its plain version on the system's near-contact
    batches at the initial rollouts of its hard_lanes.RUNS scenarios (the
    nominal piano, the cone's 32 of seed 0), by the rule of the dtype: no
    failing lane, none far from tol in the kernel only, no f64 batch short
    of plain's converged count."""
    dev = _card()
    n, sigma, _ = hard_lanes.RUNS[system]
    sys_, pb, xb, ub, _ = hard_lanes.system_problem(
        system, dtype, dev, seed=0, n=n, sigma=sigma)
    X = altro.initial_rollout(sys_, pb, xb[:, 0], ub)
    batches = hard_lanes.near_contact_batches(sys_, pb, xb, X)
    res = hard_lanes.compare(
        batches, hard_lanes.outputs(solve_socp, batches),
        hard_lanes.outputs(pdip_cuda.solve_socp_cuda, batches))
    assert hard_lanes.verdict_failures(res["totals"]) == [], res["totals"]

"""The per-lane rule that holds the float32 PDIP kernel to its plain version
(``dcol_tpu_torch/tools/hard_lanes.py::judge_lanes``), and the near-contact
lanes captured on the card (``tests/torch_fixtures/pdip_hard_lane_*.npz``).

The rule, on synthetic outputs over the near-contact fixture's batch: a
lane that ends far from tol in the kernel only fails, a borderline lane
with a good alpha passes, a lane with a bad alpha fails, and a lane far in
the plain version only is held to 2e-3.

Each captured lane is one that a float32 kernel stopped far from tol (mu
>= 10 tol) in one batch-128 main-path solve's near-contact batches, where
its plain version converged; the file holds the problems of the warp it
was launched in (8 problems, 4 lanes a team).  Five (seed 0) are an
earlier kernel's, which rounded x0^2 - |x1|^2 and the SOC line search
otherwise than the plain version; three (seeds 4-6) a variant's whose
Nesterov-Todd scaling divided where the kernel multiplied by reciprocals;
one (seed 5, midpoint (9, 10) lane 16048) the float32 kernel's that
shipped with the reciprocals.  On the CPU the port's plain version, JAX's
f32 ``solve_socp`` and JAX's Pallas kernel in interpret mode each meet the
rule against an f64 solve on every captured lane: near tol (mu < 10 tol),
alpha within 1e-4 (1 + |alpha|) of the f64 solve's.  So the far stops
were the CUDA kernel's own.  The kernel now iterates these layouts in
float64 from the float32 operands: its CPU stand-in, the plain version in
float64 on the widened inputs with the outputs rounded to float32, meets
both rules (``hard_lanes.judge``) on every lane and ends below tol.  On
the card the kernel meets them against its plain versions on each lane,
alone and in its warp.  No lane is open (``pdip_open_lane_*.npz``).
"""

import numpy as np
import pytest
import torch

from dcol_tpu.ops.cones import ConeLayout as JLayout
from dcol_tpu.ops.pdip import solve_socp as jax_solve
from dcol_tpu.ops.pdip_pallas import solve_socp_pallas
from dcol_tpu_torch.ops import pdip_cuda
from dcol_tpu_torch.ops.pdip import solve_socp
from dcol_tpu_torch.tools import hard_lanes

torch.set_num_threads(1)

LANES = hard_lanes.captured_lanes()
NAMES = [hard_lanes.load_lane(p, "cpu")["name"] for p in LANES]
OPEN = hard_lanes.captured_lanes(hard_lanes.OPEN)


@pytest.fixture(scope="module")
def fixture_batch():
    """The near-contact fixture's batch and the plain version's lanes on
    it."""
    fx = hard_lanes.load_fixture("cpu")
    prob = (fx["c"], fx["G"], fx["h"])
    out = solve_socp(*prob, fx["lay"], **fx["kw"])
    return fx, prob, hard_lanes.lanes_of(out, fx["lay"])


def _judge(fixture_batch, edit_kernel=None, edit_plain=None):
    fx, prob, plain = fixture_batch
    k, p = ({n: t.clone() for n, t in plain.items()} for _ in range(2))
    for d, edit in ((k, edit_kernel), (p, edit_plain)):
        if edit is not None:
            edit(d)
    return hard_lanes.judge_lanes(k, p, fx["lay"], prob, fx["kw"]["tol"])


def _set(lane, mu, d_alpha=0.0):
    def edit(d):
        d["mu"][lane] = mu
        d["converged"][lane] = mu < 2e-5
        d["alpha"][lane] += d_alpha
    return edit


def test_rule_agreeing_outputs_pass(fixture_batch):
    """The plain version against itself: its lanes that end above tol are
    disputed, solved in f64, and pass."""
    v = _judge(fixture_batch)
    assert v["disputed"] >= 1
    assert v["failing"] == v["kernel_only_far"] == v["plain_only_far"] == []


def test_rule_kernel_only_far_lane_fails(fixture_batch):
    """(a): a lane the kernel ends at 100 tol where plain converges fails,
    however good its alpha."""
    v = _judge(fixture_batch, edit_kernel=_set(5, 2e-3))
    assert v["failing"] == v["kernel_only_far"] == [5]
    assert v["lanes"][0]["fails"] == ["far in the kernel only"]


def test_rule_borderline_lane_with_good_alpha_passes(fixture_batch):
    """A lane the kernel ends at 3 tol (not converged, plain converged)
    with alpha 1e-5 off is disputed and passes: where a lane ends near tol
    is rounding."""
    v = _judge(fixture_batch, edit_kernel=_set(7, 6e-5, 1e-5))
    assert v["disputed"] >= 2 and v["failing"] == []
    assert v["kernel_only_far"] == v["plain_only_far"] == []


def test_rule_bad_alpha_fails(fixture_batch):
    """(b): a borderline lane whose alpha misses the f64 solve's by 1e-2,
    above 1e-4 (1 + |alpha|) and twice plain's error, fails."""
    v = _judge(fixture_batch, edit_kernel=_set(9, 4e-5, 1e-2))
    assert v["failing"] == [9] and v["kernel_only_far"] == []
    assert v["lanes"][0]["fails"] == ["alpha"]


@pytest.mark.parametrize("d_alpha, fails", [(1e-3, False), (1e-1, True)])
def test_rule_plain_only_far_lane_held_to_2e_3(fixture_batch, d_alpha,
                                               fails):
    """A lane far from tol in the plain version only: both versions' alpha
    must lie within 2e-3 (1 + |alpha|) of the f64 solve's (plain's is moved
    here; the kernel's is its converged one)."""
    v = _judge(fixture_batch, edit_plain=_set(11, 2e-3, d_alpha))
    assert v["plain_only_far"] == [11] and v["kernel_only_far"] == []
    assert v["failing"] == ([11] if fails else [])
    if fails:
        assert v["lanes"][0]["fails"] == ["plain-only far lane's alpha"]


def test_captured_lanes_are_warps():
    """Nine lanes were captured and none is open, each with its warp's 8
    problems (float32, teams of 4 when captured), its batch's settings and
    the capturing kernel's far stop, alone as in the batch."""
    assert (len(LANES), len(OPEN)) == (9, 0)
    for p in LANES + OPEN:
        f = np.load(p)
        ln = hard_lanes.load_lane(p, "cpu")
        assert ln["c"].dtype == torch.float32 and ln["c"].shape[0] == 8
        assert ln["G"].shape == (8, ln["lay"].nr, ln["c"].shape[1])
        assert ln["lane"] == int(f["batch_lane"]) % 8
        assert ln["kw"] == dict(tol=2e-5, max_iters=30, jitter=1e-6)
        assert bool(f["far_alone"])
        assert float(f["mu_kernel"]) >= hard_lanes.BORDER * ln["kw"]["tol"]
        assert float(f["mu_plain"]) < hard_lanes.BORDER * ln["kw"]["tol"]


def _meets_rule_f64(name, mu, alpha, lane):
    """Near tol and alpha within ALPHA_ATOL (1 + |alpha|) of the f64
    solve's, which converges."""
    i, lay = lane["lane"], lane["lay"]
    r64 = solve_socp(*(lane[k][i:i + 1].double() for k in ("c", "G", "h")),
                     lay, **hard_lanes.F64_KW)
    assert bool(r64.converged[0])
    a64 = float(r64.x[0, 3])
    assert mu < hard_lanes.BORDER * lane["kw"]["tol"], (name, mu)
    assert abs(alpha - a64) <= hard_lanes.ALPHA_ATOL * (1 + abs(a64)), (
        name, alpha, a64)


@pytest.mark.parametrize("solver", ["plain", "jax", "pallas_interpret"])
@pytest.mark.parametrize("path", LANES, ids=NAMES)
def test_captured_lane_reference_solvers(path, solver):
    """The port's plain version, JAX's solve_socp and JAX's Pallas kernel
    in interpret mode (as tests/test_pdip_pallas.py:42 runs it), all in
    float32 on the CPU, on the captured lane alone."""
    lane = hard_lanes.load_lane(path, "cpu")
    i, lay, kw = lane["lane"], lane["lay"], lane["kw"]
    one = [lane[k][i:i + 1] for k in ("c", "G", "h")]
    if solver == "plain":
        o = solve_socp(*one, lay, **kw)
        mu, alpha = float(hard_lanes.mu_of(o, lay)[0]), float(o.x[0, 3])
    else:
        jlay = JLayout(lay.n_ort, lay.s1, lay.s2)
        args = [a.numpy() for a in one]
        o = (jax_solve(*args, jlay, **kw) if solver == "jax" else
             solve_socp_pallas(*args, jlay, **kw, block=128,
                               interpret=True))
        s, z = (np.asarray(a)[0].astype(np.float64) for a in (o.s, o.z))
        mu, alpha = float((s * z).sum()) / lay.degree, float(
            np.asarray(o.x)[0, 3])
    _meets_rule_f64(solver, mu, alpha, lane)


def test_capture_writes_a_lane(tmp_path, fixture_batch):
    """tools/hard_lanes.py's capture on the CPU, with the plain version in
    place of the kernel and lane 162 of the fixture made far in the
    kernel's outputs: one file holding lane 162's warp (lanes 160-163: the
    layout is iterated in float64, 4 teams of 8 a warp), which loads back
    and meets the rule."""
    fx, prob, plain = fixture_batch
    k = {n: t.clone() for n, t in plain.items()}
    _set(162, 2e-3)(k)
    batch = {"name": "solved (1, 7)", **{n: fx[n] for n in ("c", "G", "h",
                                                            "lay", "kw")}}
    res = hard_lanes.compare([batch], [plain], [k])
    assert res["totals"]["kernel_only_far"] == res["totals"]["failing"] == 1
    saved = hard_lanes.capture([batch], res["batches"], str(tmp_path),
                               solve_socp)
    assert [s["lane"] for s in saved] == [162]
    assert saved[0]["path"].endswith("pdip_hard_lane_solved_1_7_162.npz")
    lane = hard_lanes.load_lane(saved[0]["path"], "cpu")
    assert lane["lane"] == 2 and lane["batch"] == "solved (1, 7)"
    assert torch.equal(lane["G"], fx["G"][160:164])
    f = np.load(saved[0]["path"])
    assert not bool(f["far_alone"])  # the plain version converges alone
    v = hard_lanes.judge_captured(solve_socp, lane)
    assert [w["failing"] for w in v.values()] == [[], []]


def plain64_rounded(c, G, h, lay, **kw):
    """The kernel's arithmetic on a float32 layout with an SOC block, on
    the CPU: the plain version in float64 on the widened inputs, x, s and
    z rounded back to float32, the flag from the float64 mu."""
    o = solve_socp(c.double(), G.double(), h.double(), lay, **kw)
    return o._replace(**{n: getattr(o, n).float() for n in ("x", "s", "z")})


@pytest.mark.parametrize("path", LANES, ids=NAMES)
def test_captured_lane_plain_f64(path):
    """The CPU stand-in of the kernel's float64 iteration on each captured
    lane, alone and in its warp: both rules (judge_captured: per lane
    against plain float32, the f64 rule against plain float64) pass, and
    the lane ends below tol."""
    lane = hard_lanes.load_lane(path, "cpu")
    assert hard_lanes.iterates_in_f64(lane["c"].dtype, lane["lay"])
    v = hard_lanes.judge_captured(plain64_rounded, lane)
    for where, w in v.items():
        assert w["failing"] == [] and not w["count_short"], (where, w)
        assert w["f64"]["failing"] == [], (where, w["f64"])
        assert w["mu"] < lane["kw"]["tol"], (where, w["mu"])


def test_judge_needs_plain_f64_on_soc_layouts(fixture_batch):
    """A float32 batch with an SOC block is iterated in float64, so judge
    holds it to both rules: it runs plain in float64 on the widened inputs
    (hard_lanes.plain_f64) itself, from the batch's settings and warm
    start, and judges lane ``at`` alone as that lane of the batch."""
    fx, prob, plain = fixture_batch
    assert hard_lanes.iterates_in_f64(torch.float32, fx["lay"])
    v = hard_lanes.judge(plain, plain, fx["lay"], prob, fx["kw"])
    p64 = hard_lanes.plain_f64(prob, fx["lay"], fx["kw"])
    assert v["conv_plain64"] == int(p64["converged"].sum())
    assert v["f64"] == hard_lanes.judge_f64(plain, p64, fx["lay"], prob,
                                            fx["kw"]["tol"])
    far = fx["lane"]
    one = hard_lanes.judge(plain, plain, fx["lay"], prob, fx["kw"], at=far)
    assert one["conv_plain64"] == int(p64["converged"][far])
    assert one["disputed"] <= 1 and one["f64"]["disputed"] <= 1


@pytest.fixture(scope="module")
def mixed_batch(fixture_batch):
    """The fixture's batch through the kernel's CPU stand-in."""
    fx, prob, plain = fixture_batch
    return hard_lanes.lanes_of(
        plain64_rounded(*prob, fx["lay"], **fx["kw"]), fx["lay"])


@pytest.mark.parametrize("edit, failing, short", [
    (None, [], False),
    (_set(5, 2e-3), [5], True),
    (_set(7, 6e-5, 1e-5), [], True),
], ids=["stand_in", "far_lane", "borderline_lane"])
def test_judge_holds_both_rules(fixture_batch, mixed_batch, edit, failing,
                                short):
    """Both rules on the fixture's batch: the stand-in passes both; a lane
    made far (100 tol) fails both; a lane made borderline (3 tol, alpha 1e-5
    off) passes the per-lane rule but leaves the converged count short of
    plain float64's by more than 0.1% of the 200 lanes."""
    fx, prob, plain = fixture_batch
    k = {n: t.clone() for n, t in mixed_batch.items()}
    if edit is not None:
        edit(k)
    v = hard_lanes.judge(k, plain, fx["lay"], prob, fx["kw"])
    assert v["failing"] == failing and v["f64"]["failing"] == failing
    assert v["count_short"] is short and v["f64"]["count_short"] is short
    assert [r for r in v["lanes"] if r.get("rule") == "f64"] == [
        dict(r, rule="f64") for r in v["f64"]["lanes"]]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("path", LANES, ids=NAMES)
def test_captured_lane_kernel_on_card(path):
    """The kernel against its plain version on the card, on the captured
    lane alone and in its warp: the rule passes on the lane."""
    dev = _card()
    v = hard_lanes.judge_captured(pdip_cuda.solve_socp_cuda,
                                  hard_lanes.load_lane(path, dev))
    for where, w in v.items():
        assert w["failing"] == [], (where, w["lanes"])
        assert w["mu"] < hard_lanes.BORDER * 2e-5, (where, w["mu"])


def test_lane_steps_on_cpu():
    """tools/lane_steps.py with the plain version: on seed 5's lane it
    converges in 16 steps, and one step from its iterate k (a warm start
    with no margin) reproduces its iterate k + 1 bitwise.  Its measurement
    needs the card and raises without one."""
    from dcol_tpu_torch.tools import lane_steps

    path, = (p for p in LANES
             if p.endswith("seed_5_midpoint_9_10_16048.npz"))
    lane = hard_lanes.load_lane(path, "cpu")
    its = lane_steps.iterates(solve_socp, lane)
    assert int(its["steps"][-1]) == 16 and its["mu"][-1] < lane["kw"]["tol"]
    for k in (13, 14, 15):
        assert lane_steps.step(solve_socp, lane, its, k) == its["mu"][k]
    assert lane_steps.parse_steps("13-15") == range(13, 16)
    with pytest.raises(RuntimeError, match="needs CUDA"):
        lane_steps.run(path, device="cpu")

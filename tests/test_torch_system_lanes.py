"""Near-contact lanes of every system, and both dtypes' rules
(``dcol_tpu_torch/tools/hard_lanes.py``), on the CPU.

- ``system_state`` and ``near_contact_batches`` for the piano mover and the
  cone through the wall in float32 and float64, at the initial rollouts (no
  solve): one flat cold batch per obstacle group at the trajectories and
  one at the midpoints, each with its scene's layout and tol.
- The float64 rule (``judge_f64``) on synthetic outputs over the f64
  piano's batch: agreeing outputs pass, a lane far from tol in the kernel
  only fails, a count short by more than 0.1% of the batch fails, a lane
  far in the plain version only is held to 2e-3; ``judge`` picks the rule
  by dtype.
- The cold PDIP iterations of the quadrotor's 7 obstacle groups at
  ``Xref`` (one scenario, 1,100 problems; ``bench.py:114-150`` tiles the
  same batch 128 times): the port's plain version against JAX's f32
  ``solve_socp`` on the same inputs, in float32 and, as the kernel now
  iterates these layouts, in float64 on the widened inputs.
- The main path's guards, and the CLI's ``--seeds`` and ``--system``.
"""

import argparse

import numpy as np
import pytest
import torch

from dcol_tpu.ops.cones import ConeLayout as JLayout
from dcol_tpu.ops.pdip import solve_socp as jax_solve
from dcol_tpu_torch.ops.cones import ConeLayout
from dcol_tpu_torch.ops.pdip import solve_socp
from dcol_tpu_torch.solver import altro
from dcol_tpu_torch.tools import hard_lanes

torch.set_num_threads(1)

F32, F64 = torch.float32, torch.float64
# each scene's PDIP tol: f32 conditioning (systems/*.py make_problem) or the
# f64 default
TOL = {("piano_mover", F32): 2e-5, ("piano_mover", F64): 1e-6,
       ("coneThroughWall", F32): 1e-5, ("coneThroughWall", F64): 1e-6}
# the port's plain f32 version against JAX's f32 solve_socp, summed cold
# iterations over the 7 groups at Xref: 9,915 against 9,931 on the CPU
# (-0.16%; group (9, 10) 2,872 against 2,886), so the sum is held to the
# 0.5% that chip_smoke.py holds the kernel to against the JAX package
COLD_ITERS_RTOL = 5e-3


def _initial(system, dtype, n, seed=0):
    """The system's scenarios and their initial rollouts (n = 1: the
    nominal problem, at sigma 0)."""
    sys_, pb, xb, ub, _ = hard_lanes.system_problem(
        system, dtype, "cpu", seed=seed, n=n, sigma=0.0 if n == 1 else 0.02)
    return sys_, pb, xb, altro.initial_rollout(sys_, pb, xb[:, 0], ub)


@pytest.mark.parametrize("dtype", [F32, F64], ids=["f32", "f64"])
@pytest.mark.parametrize("system, n", [("piano_mover", 1),
                                       ("coneThroughWall", 4)])
def test_system_near_contact_batches(system, n, dtype):
    """system_state hands the solved trajectories on (here the initial
    rollouts) and rebuilds the same scenarios; near_contact_batches makes
    one batch per group and tag with the group's layout, B = n N (obstacles
    in the group) and the scene's settings; the plain version against
    itself passes the rule of the dtype."""
    _, _, xb0, X = _initial(system, dtype, n)
    sys_, pb, xb, Xs = hard_lanes.system_state(
        system, dtype, "cpu", seed=0, n=n, sigma=0.0 if n == 1 else 0.02,
        solved=X)
    assert torch.equal(xb, xb0) and Xs is X
    if n == 1:  # the nominal problem: no perturbation
        _, _, X0, _, _ = hard_lanes.system_module(system).make_problem(
            dtype, "cpu")
        assert torch.equal(xb[0], X0)
    batches = hard_lanes.near_contact_batches(sys_, pb, xb, X)
    groups = sys_.scene.groups
    assert [b["name"] for b in batches] == (
        [f"solved {idx}" for _, idx in groups]
        + [f"midpoint {idx}" for _, idx in groups])
    opts = sys_.scene.opts
    assert opts.tol == TOL[(system, dtype)]
    for b, (lay, idx) in zip(batches, groups + groups):
        B, nr, nv = b["G"].shape
        assert B == n * sys_.N * len(idx)
        assert (nv, nr) == (lay.nv, b["lay"].nr) and b["c"].dtype == dtype
        assert (b["lay"].n_ort, b["lay"].s1, b["lay"].s2) == (
            lay.n_ort, lay.s1, lay.s2)
        assert b["kw"] == dict(tol=opts.tol, max_iters=opts.max_iters,
                               jitter=opts.jitter)
    out = hard_lanes.outputs(solve_socp, batches[:1])
    res = hard_lanes.compare(batches[:1], out, out)
    assert res["batches"][0]["dtype"] == str(dtype)[6:]
    assert hard_lanes.verdict_failures(res["totals"]) == []


@pytest.fixture(scope="module")
def f64_batch():
    """The f64 piano's batch at its initial rollout, tiled 10 times (B =
    2,400, so 0.1% of it is 2.4 lanes), and the plain version's lanes."""
    sys_, pb, xb, X = _initial("piano_mover", F64, 1)
    b = hard_lanes.near_contact_batches(sys_, pb, xb, X)[0]
    prob = tuple(a.repeat((10,) + (1,) * (a.dim() - 1))
                 for a in (b["c"], b["G"], b["h"]))
    lanes = hard_lanes.lanes_of(solve_socp(*prob, b["lay"], **b["kw"]),
                                b["lay"])
    return b, prob, lanes


def _judge_f64(f64_batch, edit_kernel=None, edit_plain=None):
    b, prob, plain = f64_batch
    k, p = ({n: t.clone() for n, t in plain.items()} for _ in range(2))
    for d, edit in ((k, edit_kernel), (p, edit_plain)):
        if edit is not None:
            edit(d)
    return hard_lanes.judge(k, p, b["lay"], prob, b["kw"])


def _far(lanes, mu=1e-3, d_alpha=0.0):
    def edit(d):
        for lane in lanes:
            d["mu"][lane] = mu
            d["converged"][lane] = False
            d["alpha"][lane] += d_alpha
    return edit


def test_f64_rule_agreeing_outputs_pass(f64_batch):
    """The plain version against itself: every lane converged, none
    disputed, the count equal."""
    assert bool(f64_batch[2]["converged"].all())
    v = _judge_f64(f64_batch)
    assert v["disputed"] == 0 and not v["count_short"]
    assert v["failing"] == v["kernel_only_far"] == v["plain_only_far"] == []


def test_f64_rule_kernel_only_far_lane_fails(f64_batch):
    """A lane the kernel ends at 1,000 tol where plain converges fails,
    though one lane short is within the count's slack."""
    v = _judge_f64(f64_batch, edit_kernel=_far([17]))
    assert v["failing"] == v["kernel_only_far"] == [17]
    assert v["lanes"][0]["fails"] == ["far in the kernel"]
    assert not v["count_short"]


@pytest.mark.parametrize("short, fails", [(2, False), (3, True)])
def test_f64_rule_count(f64_batch, short, fails):
    """Lanes the kernel ends just above tol (2 tol: near, not disputed)
    where plain converges: 2 of 2,400 are within 0.1%, 3 are not."""
    v = _judge_f64(f64_batch, edit_kernel=_far(range(5, 5 + short), 2e-6))
    assert v["disputed"] == 0 and v["failing"] == []
    assert v["count_short"] is fails


@pytest.mark.parametrize("d_alpha, fails", [(1e-3, False), (1e-1, True)])
def test_f64_rule_plain_only_far_lane_held_to_2e_3(f64_batch, d_alpha,
                                                   fails):
    """A lane far from tol in the plain version only: both alphas within
    2e-3 (1 + |alpha|) of the f64 solve's."""
    v = _judge_f64(f64_batch, edit_plain=_far([23], d_alpha=d_alpha))
    assert v["plain_only_far"] == [23] and v["kernel_only_far"] == []
    assert v["failing"] == ([23] if fails else [])
    assert not v["count_short"]


def test_judge_by_dtype(f64_batch):
    """judge holds an f32 batch to the per-lane rule: 5 lanes the kernel
    ends at 2 tol where plain converges are disputed there and pass, and
    no count is short; the same 5 in the f64 batch are short of plain's
    count by more than 0.1%."""
    sys_, pb, xb, X = _initial("piano_mover", F32, 1)
    b = hard_lanes.near_contact_batches(sys_, pb, xb, X)[0]
    prob = (b["c"], b["G"], b["h"])
    plain = hard_lanes.lanes_of(solve_socp(*prob, b["lay"], **b["kw"]),
                                b["lay"])
    assert bool(plain["converged"][5:10].all())
    k = {n: t.clone() for n, t in plain.items()}
    _far(range(5, 10), 2 * b["kw"]["tol"])(k)
    v = hard_lanes.judge(k, plain, b["lay"], prob, b["kw"])
    assert v["disputed"] >= 5 and v["failing"] == []
    assert not v["count_short"]
    v = _judge_f64(f64_batch, edit_kernel=_far(range(5, 10), 2e-6))
    assert v["count_short"] and v["disputed"] == 0


@pytest.fixture(scope="module")
def xref_groups():
    """The quadrotor's 7 groups' cold f32 batches at Xref (one scenario,
    1,100 problems), their settings, and JAX's f32 solve_socp's summed
    PDIP iterations on the same numpy inputs."""
    sys_, params, _, _, _ = hard_lanes.system_module("quadrotor") \
        .make_problem(F32, "cpu")
    rs, ps = sys_.robot_pose(params["Xref"][None])
    grouped = sys_.scene.assemble_groups(rs, ps, params["obs_r"][None, None],
                                         params["obs_p"][None, None])
    o = sys_.scene.opts
    kw = dict(tol=o.tol, max_iters=o.max_iters, jitter=o.jitter)
    groups, ref = [], 0
    for (lay, idx), (c, G, h) in zip(sys_.scene.groups, grouped):
        c, G, h = (a.reshape((-1,) + a.shape[3:]).contiguous()
                   for a in (c, G, h))
        groups.append((ConeLayout(lay.n_ort, lay.s1, lay.s2), c, G, h))
        ref += int(np.asarray(jax_solve(
            c.numpy(), G.numpy(), h.numpy(),
            JLayout(lay.n_ort, lay.s1, lay.s2), **kw).iters).sum())
    assert sum(g[1].shape[0] for g in groups) == 1100
    return groups, kw, ref


def test_cold_iterations_match_jax(xref_groups):
    """The port's plain f32 version's summed PDIP iterations against JAX's
    f32 solve_socp on the same inputs."""
    groups, kw, ref = xref_groups
    port = sum(int(solve_socp(c, G, h, cl, **kw).iters.sum())
               for cl, c, G, h in groups)
    assert abs(port / ref - 1) <= COLD_ITERS_RTOL, (port, ref)


def test_cold_iterations_f64_match_jax(xref_groups):
    """What the kernel now computes on these layouts (each has an SOC
    block): the plain version in float64 on the float32 inputs widened.
    Its summed iterations are 9,915 on the CPU, as plain float32's, within
    the 0.5% that chip_smoke.py holds the kernel to against the JAX
    package; every lane converges."""
    groups, kw, ref = xref_groups
    port, conv = 0, 0
    for cl, c, G, h in groups:
        assert hard_lanes.iterates_in_f64(c.dtype, cl)
        o = solve_socp(c.double(), G.double(), h.double(), cl, **kw)
        port += int(o.iters.sum())
        conv += int(o.converged.sum())
    assert port == 9915 and conv == 1100, (port, conv)
    assert abs(port / ref - 1) <= COLD_ITERS_RTOL, (port, ref)


def test_main_path_guards():
    """main_path_failures: the guards bench.py holds the main path to."""
    good = {"n": 128, "converged": 128, "mean_iters": 47.58, "finite": True,
            "max_h": 1e-5, "goal_err": 1e-4}
    assert hard_lanes.main_path_failures(good) == []
    for edit in ({"converged": 127}, {"mean_iters": 55.2},
                 {"mean_iters": 43.9}, {"finite": False},
                 {"max_h": 2e-3}, {"goal_err": float("nan")}):
        assert len(hard_lanes.main_path_failures(dict(good, **edit))) == 1


def test_seeds_and_systems_cli():
    """--seeds takes a seed, a range or a comma list of them; an unknown
    system is refused by the CLI and by the functions; a run over seeds
    needs the card."""
    assert hard_lanes.parse_seeds("1-6") == [1, 2, 3, 4, 5, 6]
    assert hard_lanes.parse_seeds("0") == [0]
    assert hard_lanes.parse_seeds("0-2,5") == [0, 1, 2, 5]
    for bad in ("6-1", "a", "1-", ""):
        with pytest.raises(argparse.ArgumentTypeError):
            hard_lanes.parse_seeds(bad)
    args = hard_lanes.parse_args(["--system", "coneThroughWall", "--dtype",
                                  "float32", "--seeds", "0-2"])
    assert (args.system, args.dtype, args.seeds) == (
        "coneThroughWall", "float32", [0, 1, 2])
    assert hard_lanes.RUNS["coneThroughWall"] == (32, 0.02, 80)
    defaults = hard_lanes.parse_args([])
    assert (defaults.system, defaults.dtype, defaults.seeds) == (None,) * 3
    with pytest.raises(SystemExit):
        hard_lanes.parse_args(["--system", "hexacopter"])
    with pytest.raises(ValueError, match="unknown system"):
        hard_lanes.system_problem("hexacopter", F32, "cpu", seed=0, n=1)
    with pytest.raises(ValueError, match="unknown system"):
        hard_lanes.run_seeds("hexacopter", F32, [0], device="cpu")
    with pytest.raises(RuntimeError, match="needs CUDA"):
        hard_lanes.run_seeds("quadrotor", F32, [1], device="cpu")

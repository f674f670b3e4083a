"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a nonzero exit:

  1. device: require CUDA; print the card's name and power limit;
  2. build: compile every kernel specialisation the run uses, all at once
     (nvcc, sm_90a): the PDIP kernel for each layout and dtype (with the
     wrapper's arithmetic type and team size), and the FMA probe in float32
     and float64; print the build seconds and the ptxas registers and spill
     bytes, and fail if a specialisation with float32 operands spills (the
     float32 ones iterated in float64 among them);
  3. the PDIP kernel vs its plain PyTorch version on the card, on the
     quadrotor constraint batch at Xref for 128 scenarios (7 obstacle groups,
     140,800 problems; cold, warm, warm+skip, f32) and on the golden pair
     batch (f64, against tests/goldens/pairs.json); each batch is held to
     the rule of what the kernel computes (tools/hard_lanes.py::judge): an
     f32 batch lane by lane to an f64 solve, an f64 batch to plain's
     converged count and its far lanes to an f64 solve, and an f32 batch
     the kernel iterates in f64 (every layout with an SOC block) to both,
     the second against plain run in f64 on the widened inputs; the cold
     PDIP iterations summed over the
     7 groups, plain within 0.1% and the kernel within 0.5% of the JAX
     package's 1,270,400 on the same problems; times from CUDA events, and
     each launch's bound (tools/roofline.py); the same checks run on the
     cone's batch in phase 7;
  4. the main path: the f32 quadrotor (N=100, 11 obstacles) solved for 128
     perturbed scenarios through the kernel, held to the main path's
     guards (tools/hard_lanes.py::main_path_failures: 128/128 in 44-55
     mean iterations, finite, and, independently, collision-free final
     trajectories that reach the goal); then the f64 piano mover against its
     golden trajectory (35 iterations); the PDIP launches of each, by start
     (cold, warm, warm+skip) and batch size;
  5. the FMA probe vs its plain version and the closed form on the card, on
     random lanes and on the inputs of both grids the roofline's ``peak``
     launches; its SASS (64 FMAs per loop pass); then ``peak`` at those two
     grid sizes and the roofline's ``kernel``: the PDIP kernel's time, bound
     and share of it on the quadrotor's cold (batch 64 and 128), warm and
     warm+skip launches (roofline shapes a-d);
  6. proximity: the 27 golden pairs through ``proximity_alpha`` (f64) and
     their envelope gradients through ``.backward()``; each pair's alpha,
     x, z and iteration count on the card against the CPU;
  7. cone through wall: the PDIP kernel vs its plain version on the cone's
     constraint batch at 32 perturbed initial rollouts (f32 and f64), the
     f64 solve against its reference trajectory, then the f32 batch of the
     32 perturbed scenarios (at most 80 ALTRO iterations);
  8. MPC: the f64 piano with and without dual warm starts, then the
     closed-loop quadrotor at 128 scenarios (bench_mpc.py's inputs,
     tools/hard_lanes.py::mpc_problem: horizon 40, at most 8 iterations a
     tick, 5 ticks: half of bench_mpc.py's 10, to keep the whole run
     short);
 10. distributed + checkpoint: phase 4's 128 scenarios made on the host,
     through ``distributed.initialize`` (NCCL, world size 1, cuda:0),
     ``scatter_local`` and ``solve_scattered`` capped at 20 AL iterations,
     ``checkpoint.save`` and ``load`` back onto the card, resumed to the
     normal cap through ``altro.iterate``, then ``gather_metrics``; held to
     phase 4's state (iterations, converged flags, summary, X);
 11. blocked and mesh: the f64 piano's 4 scenarios through
     ``solve_batch_blocked(block=2)`` and ``solve_batch_sharded`` over
     ``scenario_mesh()``, each against ``solve_batch`` (equal iterations, X
     to 1e-6); ``block=3`` raises;
 12. profile: ``tools/profile_breakdown.py`` at batch 64, its component
     times and the device busy share of one ALTRO iteration;
 13. CLI: ``dcol_tpu_torch.main`` on the piano with ``--verbose --no-viz``
     on the card by default, twice: with ``--f64`` converged in exactly the
     golden's iterations (35); in f32 (the default) converged, not failed,
     the goal within 1e-4, and its iterations within 2 of the JAX
     package's f32 count on the CPU (JAX_F32_PIANO_ITERS);
 14. latency: the f32 quadrotor (N=100, 11 obstacles), one scenario
     (``perturb_scenarios(n=1, seed=9, x0_sigma=0.02)``) through
     ``solve_single``: converged in 44-55 iterations and collision-free by a
     cold re-check (max h <= convio_tol), 7 PDIP launches per constraint
     batch; the wall, iterations and launches by start and B.  Then the
     PDIP kernel against its plain version on that scenario's constraint
     batches at the path's two batch sizes (cold, warm, warm+skip, phase
     3's checks): its final trajectory (B = 100 per obstacle) and 4
     line-search-like candidates between its initial and final
     trajectories (B = 400 per obstacle).  A launch with a lane far from
     tol in one version is written whole to chiprun_out/ (how phase 15's
     fixture was captured).  Last, the f64 piano with
     ``fd_jacobians=True`` against its golden (iterations, X to 1e-3).
     The p50 of several solves is ``tools/probe_latency``'s, run on its own;
 15. hard lanes: the near-contact f32 fixture
     (tests/torch_fixtures/pdip_near_contact_f32.npz, a cold batch of
     phase 14's captured on the card) through the kernel, its far lane
     alone and in place: ends near tol (mu < 10 tol), alpha within 1e-4 of
     an f64 solve; the lane's trace by max_iters (kernel alone and in
     place, plain version); the near-contact batches (tools/hard_lanes.py)
     of every system's solve: phase 4's f32 quadrotor (14 batches, 281,600
     problems) and f64 piano, phase 7's f64 cone and f32 cone batch of 32
     (converged or not), an f32 piano solved here as the CLI solves it,
     and the f32 piano's batch of 64 of benchmarks/bench_systems.py at
     seed 0 (x0_sigma 0.02; the one f32 layout the kernel iterates in f32;
     held to hard_lanes.piano_failures: 64/64 in 34-39 mean iterations,
     the cold re-check), and its cone batch, the nominal problem x 64
     capped at 80 (held to hard_lanes.cone_failures: 64/64, every
     member's iterations equal and X bitwise equal); and the cold batches
     at phase 8's MPC closed-loop states (hard_lanes.judge_mpc, where
     h_applied is taken); each judged by hard_lanes.judge (an f32 batch
     the kernel iterates in f64 by both rules), no lane failing, none
     far from tol in the kernel only, no batch short of plain's count in
     f64; the lanes captured from an earlier kernel's
     (tests/torch_fixtures/pdip_hard_lane_*.npz, each alone and in its
     warp), none failing the rule (both rules where the kernel iterates in
     f64), and the open lanes (pdip_open_lane_*.npz, known faults, none at
     present: reported, not gated); NaN isolation inside a launch on phase
     3's batches (member 9 of each
     group with a NaN c or G; cold, warm, warm+skip; every other member
     bitwise as without the poison); the f64 piano's 4 scenarios of
     tests/test_robustness.py:39 with scenario 2 poisoned, only it failing;
     and, before the near-contact batches, 3 ALTRO iterations of one
     scenario replicated as the main path's batch of 128 and as the
     piano's batch of 64 (tools/replicas.py), every state field equal
     across members;
  9. a JSON line of kernel results, then the last line
     {"ok": true, "device": {...}}.

Each path of phases 4-15 runs with every kernel's launch count set to 0 just
before it and read just after.  A detailed record goes to
chiprun_out/chip_smoke.json.
"""

import contextlib
import dataclasses
import io
import json
import os
import re
import socket
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
BATCH = 128
DEVICE = "cuda:0"
PDIP_TPU_KERNEL = "dcol_tpu/ops/pdip_pallas.py:464"
FMA_TPU_KERNEL = "tools/roofline.py:231"
F32, F64 = torch.float32, torch.float64
RESUME_CAP = 20   # phase 10: AL iterations before the checkpoint
# proximity on the card vs on the CPU, f64 at tol 1e-10: x and z
PROX_RTOL, PROX_ATOL = 1e-8, 1e-8
# phase 15: the near-contact f32 fixture (tests/torch_fixtures/)
HARD_ALPHA_ATOL = 1e-4  # the kernel's alpha on its far lane against f64
# phase 13: the JAX package's ALTRO iterations on the nominal f32 piano on
# the CPU (its CLI's --f32 solve; tests/test_torch_piano_f32_count.py computes
# it and the port's plain f32 count, which equal it), the band the CLI's f32
# piano on the card is held to around it, and the goal error of the golden
# test (tests/test_torch_altro.py)
JAX_F32_PIANO_ITERS = 35
F32_PIANO_ITERS_ATOL = 2
GOAL_ATOL = 1e-4
# phase 15: ALTRO iterations of replicated batches, every state field held
# equal across members (tools/replicas.py): the main path's batch of 128 and
# bench_systems.py's piano batch of 64
REPLICA_ITERATIONS = 3
# phase 3: PDIP iterations summed over the 7 groups' cold batches at Xref
# for 128 scenarios (140,800 problems), as bench.py:114-150 counts them: the
# JAX package's Pallas kernel counted 1,270,400 there (BENCH_r05.json);
# the plain version must come within 0.1% of it, the kernel within 0.5%
JAX_COLD_ITERS = 1_270_400
COLD_ITERS_RTOL = {"plain": 1e-3, "kernel": 5e-3}
NAN_MEMBER = 9  # shares its warp with 3 healthy teams of 8


def log(*a):
    print(*a, flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def golden_shapes():
    from dcol_tpu_torch.geometry import primitives as prim

    A, b = prim.n_sided_polygon(5, 0.6)
    return {
        "polytope": prim.rect_prism(2.5, 0.15, 0.01),
        "sphere": prim.sphere(0.8),
        "cone": prim.cone(2.0, np.deg2rad(22)),
        "capsule": prim.capsule(0.2, 5.0),
        "cylinder": prim.cylinder(0.6, 3.0),
        "polygon": prim.polygon(A, b, 0.2),
    }


def golden_cases():
    with open(os.path.join(ROOT, "tests", "goldens", "pairs.json")) as f:
        return json.load(f)


def golden_batch(dtype, device):
    """The sphere-robot golden pairs padded to one layout (the batch of
    tests/test_pdip_pallas.py) and their reference alphas."""
    from dcol_tpu_torch.geometry import assembly
    from dcol_tpu_torch.ops.cones import ConeLayout

    cases = [c for c in golden_cases() if c["k1"] == "sphere"]
    shapes = golden_shapes()
    robot = shapes["sphere"]
    obs = [shapes[c["k2"]] for c in cases]
    nv, n_ort = assembly.scene_dims(robot, obs)
    T = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    cs, Gs, hs = [], [], []
    for case, o in zip(cases, obs):
        c, G, h = assembly.assemble_pair(
            robot, o, assembly.make_layout(robot, o, nv, n_ort),
            T(case["r1"]), T(case["p1"]), T(case["r2"]), T(case["p2"]))
        cs.append(c); Gs.append(G); hs.append(h)
    lay = ConeLayout(n_ort, assembly.S_PAD, assembly.S_PAD)
    gold = np.array([c["alpha"] for c in cases])
    return torch.stack(cs), torch.stack(Gs), torch.stack(hs), lay, gold


class Run:
    """State shared by the phases: the device, the record written to
    chiprun_out/, and the launch counts of every path."""

    def __init__(self, dev, smi):
        self.dev = dev
        self.record = {"device": smi, "torch": torch.__version__,
                       "paths": {}}

    def path(self, name, fn, kernels):
        """Run one path with every kernel's launch count set to 0 just
        before it and read just after, and the peak of allocated device
        memory over it; fail unless each kernel in ``kernels`` launched."""
        from dcol_tpu_torch.ops import fma_peak, pdip_cuda

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        pdip_cuda.launches = 0
        pdip_cuda.tally.clear()
        fma_peak.launches = 0
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        counts = {"pdip": pdip_cuda.launches, "fma_peak": fma_peak.launches}
        by_shape = {" ".join(map(str, k)): n
                    for k, n in sorted(pdip_cuda.tally.items())}
        self.record["paths"][name] = dict(counts, wall_s=wall,
                                          peak_bytes=peak,
                                          pdip_by_shape=by_shape)
        log(f"[launches] {name}: {counts} in {wall:.3f} s, peak "
            f"{peak / 2**20:.1f} MiB allocated")
        for k in kernels:
            check(counts[k] > 0, f"path {name!r} launched no {k} kernel")
        return out, wall

    def launches(self, kernel):
        return sum(p[kernel] for p in self.record["paths"].values())

    def log_shapes(self, name):
        """The PDIP launches of path ``name`` by start and batch size: the
        wrapper's tally, keyed (B, nv, n_ort, s1, s2, start)."""
        by = {}
        for key, n in self.record["paths"][name]["pdip_by_shape"].items():
            B, *_, start = key.split()
            by[(start, int(B))] = by.get((start, int(B)), 0) + n
        log(f"[launches] {name}, PDIP by start and B: " + ", ".join(
            f"{st} B={B:,}: {n}" for (st, B), n in sorted(by.items())))


# -- 2. build ----------------------------------------------------------------

def phase_build(run):
    from dcol_tpu_torch.ops import fma_peak, nvcc_build, pdip_cuda
    from dcol_tpu_torch.ops.cones import ConeLayout
    from dcol_tpu_torch.ops.proximity import pair_layouts
    from dcol_tpu_torch.systems import (
        cone_through_wall, piano_mover, quadrotor)

    def scene_specs(mod, dtype):
        sys_ = mod.make_system()
        return [(dtype, lay.nv, ConeLayout(lay.n_ort, lay.s1, lay.s2))
                for lay, _ in sys_.scene.groups]

    shapes = golden_shapes()
    _, gG, _, glay, _ = golden_batch(F64, "cpu")
    specs = scene_specs(quadrotor, F32)
    specs.append((F64, gG.shape[-1], glay))
    specs += scene_specs(piano_mover, F64)
    specs += scene_specs(piano_mover, F32)  # the CLI's piano, phases 13, 15
    specs += scene_specs(cone_through_wall, F32)
    specs += scene_specs(cone_through_wall, F64)
    for case in golden_cases():
        pl, cl = pair_layouts(shapes[case["k1"]], shapes[case["k2"]])
        specs.append((F64, pl.nv, cl))
    specs = list(dict.fromkeys(specs))
    jobs = [lambda a=a: pdip_cuda.build(*a) for a in specs]
    jobs += [lambda d=d: fma_peak.build(d) for d in (F32, F64)]
    t0 = time.perf_counter()
    builds = nvcc_build.run_parallel(jobs)
    build_wall = time.perf_counter() - t0
    log(f"[build] {len(builds)} specialisations in {build_wall:.2f} s wall")
    run.record["build_wall_s"] = build_wall
    run.record["builds"] = []
    f32_spills = []
    for b in builds:
        if b.key[0] == "pdip":
            _, dt, arith, nv, n_ort, s1, s2, team = b.key
            name = (f"pdip {str(dt)[6:]} arithmetic={str(arith)[6:]} nv={nv} "
                    f"n_ort={n_ort} s1={s1} s2={s2} team={team}")
        else:
            dt = b.key[1]
            name = f"fma_peak {str(dt)[6:]}"
        secs = "cached" if b.seconds is None else f"{b.seconds:.2f} s"
        regs = [int(ln.split("Used ")[1].split()[0]) for ln in b.ptxas
                if "Used " in ln]
        spill = spill_bytes(b.ptxas)
        log(f"[build] {name}: {secs}; registers per kernel variant "
            f"{'/'.join(map(str, regs))}; spill bytes (stores + loads, "
            f"worst variant) {spill}")
        run.record["builds"].append({"spec": name, "seconds": b.seconds,
                                     "registers": regs, "spill_bytes": spill,
                                     "ptxas": list(b.ptxas)})
        if dt == F32 and spill:
            f32_spills.append(name)
    check(not f32_spills, f"f32 specialisations spill: {f32_spills}")


def spill_bytes(ptxas):
    """The largest spill stores + loads of any kernel variant in a ptxas -v
    report."""
    worst = 0
    for ln in ptxas:
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m:
            worst = max(worst, int(m.group(1)) + int(m.group(2)))
    return worst


def save_far_batch(stem, c, G, h, cl, kw, start, far, warm=None, skip=None):
    """Write one launch's whole batch, its cone layout and settings and its
    far lanes to chiprun_out/<stem>.npz, as the card computed them."""
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    path = os.path.join(ROOT, "chiprun_out", stem + ".npz")
    arrs = dict(c=c, G=G, h=h)
    if warm is not None:
        arrs.update(x_warm=warm[0], s_warm=warm[1], z_warm=warm[2])
    if skip is not None:
        arrs["skip"] = skip
    np.savez(path, **{k: v.cpu().numpy() for k, v in arrs.items()},
             far_lanes=np.asarray(far, dtype=np.int64),
             layout=np.array([cl.n_ort, cl.s1, cl.s2]), start=start,
             tol=kw["tol"], jitter=kw["jitter"], max_iters=kw["max_iters"])
    log(f"[pdip] far lanes {far} of a {start} launch written to {path}")


def compare_pdip(tag, c, G, h, cl, kw, capture=None):
    """The PDIP kernel against its plain version on one flat batch: cold,
    warm (G, h x 1.001 from the plain cold optimum) and warm with every
    other lane skipped.  Returns the per-variant agreement.  With
    ``capture`` (a file stem), a launch with far lanes is written to
    chiprun_out/ (:func:`save_far_batch`)."""
    from dcol_tpu_torch.ops import pdip_cuda
    from dcol_tpu_torch.ops.pdip import solve_socp
    from dcol_tpu_torch.tools import hard_lanes

    B = c.shape[0]
    ref = solve_socp(c, G, h, cl, **kw)
    out = pdip_cuda.solve_socp_cuda(c, G, h, cl, **kw)
    warm = (ref.x, ref.s, ref.z)
    G2, h2 = G * (1 + 1e-3), h * (1 + 1e-3)
    refw = solve_socp(c, G2, h2, cl, warm=warm, **kw)
    outw = pdip_cuda.solve_socp_cuda(c, G2, h2, cl, warm=warm, **kw)
    skip = torch.arange(B, device=c.device) % 2 == 0
    refs = solve_socp(c, G2, h2, cl, warm=warm, skip=skip, **kw)
    outs = pdip_cuda.solve_socp_cuda(c, G2, h2, cl, warm=warm, skip=skip,
                                     **kw)
    torch.cuda.synchronize()
    row = {"B": B, "max_abs_err": 0.0}
    for var, o, r, prob, wk, sk in (
            ("cold", out, ref, (c, G, h), None, None),
            ("warm", outw, refw, (c, G2, h2), warm, None),
            ("warm+skip", outs, refs, (c, G2, h2), warm, skip)):
        err = float((o.x[:, 3] - r.x[:, 3]).abs().max())
        torch.testing.assert_close(o.x[:, 3], r.x[:, 3], rtol=2e-3, atol=2e-3)
        dis = o.converged != r.converged
        agree = 1.0 - float(dis.double().mean())
        n_k, n_p = int(o.converged.sum()), int(r.converged.sum())
        # Where a float32 lane ends near tol is rounding: 0-3% of lanes
        # freeze at mu 1-3.3 tol in either version, so the converged flags of
        # two f32 implementations cannot agree lane for lane.  What the
        # caller reads is alpha.  Each batch is held to the rule of what the
        # kernel computes (tools/hard_lanes.py::judge): an f32 kernel lane by
        # lane (judge_lanes: every disputed lane against an f64 solve, none
        # stopping far from tol in the kernel only, none with alpha further
        # from f64 than max(2 x plain's error, 1e-4 (1 + |alpha|))); an f64
        # kernel by the count rule (no fewer converged lanes than plain,
        # 0.1% of lanes slack) and its far lanes against an f64 solve
        # (judge_f64); and an f32 batch it iterates in f64 by both, the
        # second against plain run in f64 on the widened inputs
        v = hard_lanes.judge(hard_lanes.lanes_of(o, cl),
                             hard_lanes.lanes_of(r, cl), cl, prob, kw,
                             warm=wk, skip=sk)
        check(not v["count_short"], f"{tag} {var} {cl}: kernel converged "
                                    f"{n_k} lanes, plain {n_p}"
                                    + ("" if "f64" not in v else
                                       f", plain f64 {v['conv_plain64']}"))
        for fr in v["lanes"]:
            log(f"[pdip] {tag} {var} {cl}: " + hard_lanes.describe_lane(fr))
        if v["lanes"] and capture is not None:
            save_far_batch(f"{capture}_{var.replace('+', '_')}", *prob, cl,
                           kw, var, [fr["lane"] for fr in v["lanes"]], wk,
                           sk)
        check(not v["failing"], f"{tag} {var} {cl}: lanes {v['failing']} "
                                f"fail the per-lane rule")
        it_k = float(o.iters.double().mean())
        it_p = float(r.iters.double().mean())
        check(abs(it_k - it_p) <= 0.05 * it_p,
              f"{tag} {var} {cl}: mean iters {it_k} vs {it_p}")
        row["max_abs_err"] = max(row["max_abs_err"], err)
        row[var] = {"max_abs_err_alpha": err, "converged_agree": agree,
                    "conv_kernel": n_k / B, "conv_plain": n_p / B,
                    "mean_iters_kernel": it_k, "mean_iters_plain": it_p,
                    "sum_iters_kernel": int(o.iters.sum()),
                    "sum_iters_plain": int(r.iters.sum()),
                    "disputed": v["disputed"], "failing": v["failing"],
                    "far_lanes": v["lanes"]}
        if "f64" in v:
            row[var].update(conv_plain64=v["conv_plain64"] / B,
                            f64_disputed=v["f64"]["disputed"])
    check(int(outs.iters[skip].max()) == 0 and
          int(refs.iters[skip].max()) == 0, f"{tag}: skipped lanes iterated")
    for a, b in zip(outs[:3], refs[:3]):
        check(torch.equal(a[skip], b[skip]),
              f"{tag}: skipped lanes differ from the plain version "
              f"({float((a[skip] - b[skip]).abs().max())})")
    return row


def describe(row):
    return (f"alpha err cold {row['cold']['max_abs_err_alpha']:.3e} "
            f"warm {row['warm']['max_abs_err_alpha']:.3e} "
            f"skip {row['warm+skip']['max_abs_err_alpha']:.3e}; converged "
            f"kernel/plain {row['cold']['conv_kernel']:.4f}/"
            f"{row['cold']['conv_plain']:.4f} (flags agree "
            f"{row['cold']['converged_agree']:.4f}); iters "
            f"cold {row['cold']['mean_iters_kernel']:.3f}/"
            f"{row['cold']['mean_iters_plain']:.3f} warm "
            f"{row['warm']['mean_iters_kernel']:.3f}/"
            f"{row['warm']['mean_iters_plain']:.3f}")


# -- 3. PDIP kernel vs plain version ----------------------------------------

def phase_pdip(run):
    from dcol_tpu_torch.ops import pdip_cuda
    from dcol_tpu_torch.ops.cones import ConeLayout
    from dcol_tpu_torch.ops.pdip import solve_socp
    from dcol_tpu_torch.parallel.batch import perturb_scenarios
    from dcol_tpu_torch.systems import quadrotor
    from dcol_tpu_torch.tools import roofline

    dev = run.dev
    sys_, params, X0, U0, cfg = quadrotor.make_problem(F32, dev)
    scene = sys_.scene
    groups = [(lay, idx, ConeLayout(lay.n_ort, lay.s1, lay.s2))
              for lay, idx in scene.groups]
    check(len(groups) == 7, f"quadrotor has {len(groups)} groups, not 7")
    params_b, _, _ = perturb_scenarios(params, X0, U0, n=BATCH, seed=0,
                                       x0_sigma=0.02)
    rs, ps = sys_.robot_pose(params_b["Xref"])
    grouped = scene.assemble_groups(rs, ps, params_b["obs_r"][:, None],
                                    params_b["obs_p"][:, None])
    opts = scene.opts
    kw = dict(tol=opts.tol, max_iters=opts.max_iters, jitter=opts.jitter)
    n_total, max_err, ms_total, plain_total = 0, 0.0, 0.0, 0.0
    bound_total, ceiling_total, bound_by = 0.0, 0.0, set()
    run.record["groups"] = []
    run.xref_batches = []  # phase 15 poisons them
    for (lay, idx, cl), (c, G, h) in zip(groups, grouped):
        B = c.shape[0] * c.shape[1] * c.shape[2]
        c, G, h = (a.reshape((B,) + a.shape[3:]).contiguous()
                   for a in (c, G, h))
        run.xref_batches.append((idx, cl, c, G, h, kw))
        n_total += B
        row = compare_pdip(f"obstacles {idx}", c, G, h, cl, kw)
        row["layout"] = [lay.nv, cl.n_ort, cl.s1, cl.s2]
        max_err = max(max_err, row["max_abs_err"])
        ms, sol = roofline.time_launch(
            lambda: pdip_cuda.solve_socp_cuda(c, G, h, cl, **kw), reps=3)
        plain, _ = roofline.time_launch(
            lambda: solve_socp(c, G, h, cl, **kw), reps=3)
        acc = roofline.account(lay.nv, cl, "cold", B, ms,
                               float(sol.iters.double().sum()))
        ms_total += ms
        plain_total += plain
        bound_total += acc["bound_ms"]
        ceiling_total += acc["arith_bound_ms"]
        row.update(kernel_ms=ms, plain_ms=plain, bound_ms=acc["bound_ms"],
                   bound_by=acc["bound_by"],
                   arith_bound_ms=acc["arith_bound_ms"])
        bound_by.add(acc["bound_by"])
        run.record["groups"].append(row)
        log(f"[pdip] obstacles {idx} nv={lay.nv} {cl} B={B}: "
            f"{describe(row)}; cold time kernel {ms:.4f} ms, plain "
            f"{plain:.3f} ms, bound {1e3 * acc['bound_ms']:.2f} us "
            f"({acc['bound_by']}; the kernel's ceiling in {acc['arith']} "
            f"{1e3 * acc['arith_bound_ms']:.2f} us)")
    check(n_total == BATCH * sys_.N * scene.n_obs,
          f"constraint batch has {n_total} problems")
    log(f"[pdip] cold constraint batch of {n_total} problems: kernel "
        f"{ms_total:.4f} ms, plain {plain_total:.3f} ms, bound "
        f"{1e3 * bound_total:.2f} us, the kernel's ceiling "
        f"{1e3 * ceiling_total:.2f} us (sums over 7 groups)")
    cold_iters = {}
    for ver, rtol in COLD_ITERS_RTOL.items():
        total = sum(r["cold"][f"sum_iters_{ver}"] for r in run.record["groups"])
        rel = total / JAX_COLD_ITERS - 1
        cold_iters[ver] = {"iters": total, "rel_jax": rel}
        log(f"[pdip] cold PDIP iterations over the 7 groups, {ver}: {total:,} "
            f"against the JAX package's {JAX_COLD_ITERS:,} ({100 * rel:+.4f}%,"
            f" limit {100 * rtol:g}%)")
        check(abs(rel) <= rtol, f"cold PDIP iterations of the {ver} version "
                                f"{total:,}, JAX {JAX_COLD_ITERS:,}")
    run.record["cold_iters"] = cold_iters

    gc, gG, gh, glay, gold = golden_batch(F64, dev)
    gout = pdip_cuda.solve_socp_cuda(gc, gG, gh, glay, tol=1e-9, max_iters=40)
    gref = solve_socp(gc, gG, gh, glay, tol=1e-9, max_iters=40)
    torch.cuda.synchronize()
    check(bool(gout.converged.all()), "f64 golden batch did not converge")
    gerr = float(np.abs(gout.x[:, 3].cpu().numpy() - gold).max())
    np.testing.assert_allclose(gout.x[:, 3].cpu().numpy(), gold, rtol=1e-6,
                               atol=1e-8)
    check(torch.equal(gout.iters, gref.iters), "f64 golden iteration counts "
                                               "differ from the plain version")
    log(f"[pdip] f64 golden pairs: max |alpha - golden| {gerr:.3e}, "
        f"iters {gout.iters.tolist()} (plain {gref.iters.tolist()})")
    run.record.update(golden_f64_max_err=gerr, constraint_batch=n_total)
    run.record["pdip"] = {"max_abs_err": max_err, "ms": ms_total,
                          "plain_ms": plain_total, "bound_ms": bound_total,
                          "bound_by": (bound_by.pop() if len(bound_by) == 1
                                       else "mixed"),
                          "arith_bound_ms": ceiling_total}


# -- 4. the main path ----------------------------------------------------------

def phase_quadrotor(run):
    from dcol_tpu_torch.parallel.batch import solve_batch
    from dcol_tpu_torch.systems import piano_mover
    from dcol_tpu_torch.tools import hard_lanes

    dev = run.dev
    sys_, params_b, X0_b, U0_b, cfg = hard_lanes.system_problem(
        "quadrotor", F32, dev, seed=0, n=BATCH)
    st, wall = run.path(
        "quadrotor solve_batch",
        lambda: solve_batch(sys_, params_b, cfg, X0_b, U0_b), ["pdip"])
    check(st.X.shape == (BATCH, sys_.N, sys_.nx), f"X shape {st.X.shape}")
    # the main path's guards (tools/hard_lanes.py::main_path_failures):
    # 128/128 converged in 44-55 mean iterations, finite X and U, and an
    # independent cold re-evaluation of the final trajectories that finds
    # no collision and the goal reached
    stats = hard_lanes.solve_stats(sys_, params_b, st)
    log(f"[main] f32 quadrotor N={sys_.N}, batch {BATCH}: {wall:.3f} s wall, "
        f"converged {stats['converged']}/{BATCH}, failed {stats['failed']}, "
        f"mean iters {stats['mean_iters']:.4f}, max iters "
        f"{stats['max_iters']}")
    run.log_shapes("quadrotor solve_batch")
    log(f"[main] cold re-check of converged trajectories: max h = 1 - alpha "
        f"{stats['max_h']:.3e}, max |x_N - x_goal| {stats['goal_err']:.3e}")
    missed = hard_lanes.main_path_failures(stats)
    check(not missed, f"the main path misses its guards: {missed}")
    run.record["main"] = {"wall_s": wall, "converged": stats["converged"],
                          "batch": BATCH, "mean_iters": stats["mean_iters"],
                          "max_iters": stats["max_iters"],
                          "max_h": stats["max_h"]}
    run.main_state = (X0_b, st)  # phase 10 holds its path to this state
    # phase 15 judges the near-contact problems of each solve in this list:
    # (system, dtype, seed, scenarios, x0_sigma) -> (initial, solved
    # trajectories)
    run.solved = {("quadrotor", F32, 0, BATCH, 0.02): (X0_b, st.X)}

    # the cheapest end-to-end golden: the f64 piano mover, 35 iterations
    sys_p, params_p, X0_p, U0_p, cfg_p = piano_mover.make_problem(F64, dev)
    stp, wall = run.path(
        "piano solve_batch",
        lambda: solve_batch(sys_p, {k: v[None] for k, v in params_p.items()},
                            cfg_p, X0_p[None], U0_p[None]), ["pdip"])
    gp = np.load(os.path.join(ROOT, "tests", "goldens", "ref_piano_mover.npz"))
    perr = float(np.abs(stp.X[0].cpu().numpy() - gp["X"]).max())
    log(f"[main] f64 piano mover: {wall:.3f} s, converged "
        f"{bool(stp.converged[0])}, iters {int(stp.iter[0])} (golden "
        f"{int(gp['iters'])}), max |X - X_golden| {perr:.3e}")
    run.log_shapes("piano solve_batch")
    check(bool(stp.converged[0]) and int(stp.iter[0]) == int(gp["iters"])
          and perr < 1e-3, "piano mover misses its golden")
    run.solved[("piano_mover", F64, 0, 1, 0.0)] = (X0_p[None], stp.X)


# -- 5. FMA probe and the roofline ------------------------------------------

def phase_roofline(run):
    from dcol_tpu_torch.ops import fma_peak
    from dcol_tpu_torch.tools import roofline

    dev = run.dev
    inner = roofline.PEAK_INNER
    rec = run.record["fma_peak"] = {}
    # the kernel against its plain version and the closed form on random
    # lanes, and on the inputs of both grids that roofline peak launches
    rng = np.random.default_rng(0)
    L = 4096
    xs = np.concatenate([rng.uniform(0.5, 1.0, (8, L)),
                         rng.uniform(0.99, 0.9999, (1, L)),
                         rng.uniform(1e-3, 1e-2, (1, L))])
    grids = {"random": L, **roofline.grid_sizes(dev)}
    for dtype, rtol in ((F32, 1e-4), (F64, 1e-12)):
        key = str(dtype)[6:]
        rec[key] = {"grids": {}}
        for gname, lanes in grids.items():
            x = (torch.as_tensor(xs, dtype=dtype, device=dev)
                 if gname == "random"
                 else roofline.peak_input(dtype, lanes, dev))
            k = fma_peak.fma_chains_cuda(x, inner)
            p = fma_peak.fma_chains(x, inner)
            exact = fma_peak.closed_form(x, inner)
            torch.cuda.synchronize()
            rel = lambda a: float(((a.double() - exact).abs()
                                   / exact.abs()).max())
            rel_k, rel_p = rel(k), rel(p)
            rel_kp = float(((k.double() - p.double()).abs()
                            / exact.abs()).max())
            err = float((k - p).abs().max())
            check(rel_k <= rtol and rel_p <= rtol and rel_kp <= rtol,
                  f"FMA probe {key} {gname} ({lanes} lanes): relative error "
                  f"vs closed form kernel {rel_k:.3e}, plain {rel_p:.3e}; "
                  f"|kernel - plain| / |closed form| {rel_kp:.3e} (limit "
                  f"{rtol})")
            rec[key]["grids"][gname] = {
                "lanes": lanes, "max_abs_err": err, "rel_err_kernel": rel_k,
                "rel_err_plain": rel_p, "rel_kernel_plain": rel_kp}
            log(f"[fma] {key} {gname} grid, {lanes:,} lanes: |kernel - "
                f"plain| {err:.3e} ({rel_kp:.3e} relative); relative error "
                f"vs closed form kernel {rel_k:.3e} / plain {rel_p:.3e} "
                f"(limit {rtol})")
            del x, k, p, exact
        body, total = fma_peak.sass_fma_count(dtype)
        check(body == fma_peak.FMAS_PER_PASS,
              f"FMA probe {key}: {body} FMAs in the SASS loop body, not 64")
        x_jax = roofline.peak_input(dtype, grids["jax"], dev)
        ms, _ = roofline.time_launch(
            lambda: fma_peak.fma_chains_cuda(x_jax, inner), reps=3)
        plain, _ = roofline.time_launch(
            lambda: fma_peak.fma_chains(x_jax, inner), reps=3)
        lanes = grids["jax"]
        bound, by = roofline.bound_seconds(
            2.0 * lanes * inner * fma_peak.FMAS_PER_PASS,
            (x_jax.numel() + lanes) * x_jax.element_size(), dtype)
        rec[key].update(
            bound_ms=1e3 * bound, bound_by=by,
            max_abs_err=max(g["max_abs_err"]
                            for g in rec[key]["grids"].values()),
            sass_loop_fmas=body, sass_total_fmas=total, ms=ms,
            plain_ms=plain)
        log(f"[fma] {key}: SASS {'FFMA' if dtype == F32 else 'DFMA'} {body} "
            f"per loop pass ({total} in the kernel); {grids['jax']:,} lanes "
            f"x {inner} passes: kernel {ms:.4f} ms, plain {plain:.3f} ms")

    table, _ = run.path("roofline peak",
                        lambda: roofline.peak_table(dev, out=log),
                        ["fma_peak"])
    run.record["peak"] = table
    f32_full = [r for r in table["rows"]
                if r["dtype"] == "float32" and r["grid"] == "full_card"][0]
    check(0.0 < f32_full["of_nominal"] <= 1.05,
          f"f32 peak is {f32_full['of_nominal']:.3f} of nominal")
    peak_flops = f32_full["tflops"] * 1e12

    res, _ = run.path("roofline kernel",
                      lambda: roofline.kernel(peak_flops, device=dev,
                                              out=log), ["pdip"])
    run.record["roofline_kernel"] = res
    for r in res["rows"]:
        check(0.0 < r["of_peak"] <= 1.0 and 0.0 < r["of_bound"] <= 1.0,
              f"shape {r['shape']} group {r['obstacles']}: {r['of_peak']} of "
              f"the peak, {r['of_bound']} of the bound")


# -- 6. proximity ---------------------------------------------------------------

def phase_proximity(run):
    from dcol_tpu_torch.ops.proximity import proximity, proximity_alpha

    dev = run.dev
    shapes = golden_shapes()
    cases = golden_cases()

    def solve_all():
        out = []
        for case in cases:
            s1, s2 = shapes[case["k1"]], shapes[case["k2"]]
            poses = [torch.tensor(case[k], dtype=F64, device=dev,
                                  requires_grad=True)
                     for k in ("r1", "p1", "r2", "p2")]
            a = proximity_alpha(s1, s2, *poses, tol=1e-10, max_iters=40)
            a.backward()
            out.append((a.detach(), [p.grad for p in poses]))
        return out

    res, wall = run.path("proximity golden pairs", solve_all, ["pdip"])
    a_err, g_err = 0.0, 0.0
    for case, (a, grads) in zip(cases, res):
        tag = f"{case['k1']} vs {case['k2']}"
        np.testing.assert_allclose(float(a), case["alpha"], rtol=1e-6,
                                   atol=1e-8, err_msg=tag)
        got = torch.cat(grads).cpu().numpy()
        np.testing.assert_allclose(got, np.array(case["grad"]), rtol=2e-4,
                                   atol=5e-5, err_msg=tag)
        a_err = max(a_err, abs(float(a) - case["alpha"]))
        g_err = max(g_err, float(np.abs(got - np.array(case["grad"])).max()))
    # every pair through proximity on the card and on the CPU (the plain
    # version): the same iteration count, alpha, x and z
    dx = dz = 0.0
    for case in cases:
        tag = f"{case['k1']} vs {case['k2']}"
        s1, s2 = shapes[case["k1"]], shapes[case["k2"]]
        args = [torch.tensor(case[k], dtype=F64)
                for k in ("r1", "p1", "r2", "p2")]
        on_card = proximity(s1, s2, *[a.to(dev) for a in args], tol=1e-10,
                            max_iters=40)
        on_cpu = proximity(s1, s2, *args, tol=1e-10, max_iters=40)
        check(bool(on_card.converged) and bool(on_cpu.converged)
              and int(on_card.iters) == int(on_cpu.iters),
              f"{tag}: card/CPU converged {bool(on_card.converged)}/"
              f"{bool(on_cpu.converged)}, iterations {int(on_card.iters)}/"
              f"{int(on_cpu.iters)}")
        for name, a, b in (("x", on_card.x, on_cpu.x),
                           ("z", on_card.z, on_cpu.z)):
            torch.testing.assert_close(
                a.cpu(), b, rtol=PROX_RTOL, atol=PROX_ATOL,
                msg=lambda m, n=name: f"{tag}: {n} card vs CPU: {m}")
        dx = max(dx, float((on_card.x.cpu() - on_cpu.x).abs().max()))
        dz = max(dz, float((on_card.z.cpu() - on_cpu.z).abs().max()))
    log(f"[proximity] 27 golden pairs on the card, f64: {wall:.3f} s, max "
        f"|alpha - golden| {a_err:.3e}, max |grad - FD golden| {g_err:.3e}; "
        f"card vs CPU (plain version): equal iteration counts, max |dx| "
        f"{dx:.3e} (alpha is x[3]), max |dz| {dz:.3e} (limit {PROX_ATOL} + "
        f"{PROX_RTOL} relative)")
    run.record["proximity"] = {"wall_s": wall, "alpha_err": a_err,
                               "grad_err": g_err, "card_cpu_max_dx": dx,
                               "card_cpu_max_dz": dz}


# -- 7. cone through wall ---------------------------------------------------

def phase_cone(run):
    from dcol_tpu_torch.ops.cones import ConeLayout
    from dcol_tpu_torch.parallel.batch import perturb_scenarios, solve_batch
    from dcol_tpu_torch.solver import altro
    from dcol_tpu_torch.systems import cone_through_wall
    from dcol_tpu_torch.tools import hard_lanes

    dev = run.dev
    n = 32
    # the PDIP kernel vs its plain version on the cone's constraint batch
    # at the initial rollouts of the 32 perturbed scenarios, in both dtypes
    run.record["cone_pdip"] = {}
    for dtype in (F32, F64):
        sys_, params, X0, U0, cfg = cone_through_wall.make_problem(dtype, dev)
        pb, xb, ub = perturb_scenarios(params, X0, U0, n=n, seed=0,
                                       x0_sigma=0.02)
        X = altro.initial_rollout(sys_, pb, xb[:, 0], ub)
        scene, opts = sys_.scene, sys_.scene.opts
        rs, ps = sys_.robot_pose(X)
        grouped = scene.assemble_groups(rs, ps, pb["obs_r"][:, None],
                                        pb["obs_p"][:, None])
        kw = dict(tol=opts.tol, max_iters=opts.max_iters, jitter=opts.jitter)
        for (lay, idx), (c, G, h) in zip(scene.groups, grouped):
            cl = ConeLayout(lay.n_ort, lay.s1, lay.s2)
            B = c.shape[0] * c.shape[1] * c.shape[2]
            c, G, h = (a.reshape((B,) + a.shape[3:]).contiguous()
                       for a in (c, G, h))
            row = compare_pdip(f"cone {str(dtype)[6:]}", c, G, h, cl, kw)
            row["layout"] = [lay.nv, cl.n_ort, cl.s1, cl.s2]
            run.record["cone_pdip"][f"{str(dtype)[6:]} {idx}"] = row
            log(f"[cone] PDIP kernel vs plain, {str(dtype)[6:]}, walls {idx} "
                f"nv={lay.nv} {cl} B={B} (tol {opts.tol:g}): {describe(row)}")

    sys_, params, X0, U0, cfg = cone_through_wall.make_problem(F64, dev)
    pb = {k: v[None] for k, v in params.items()}
    st, wall = run.path(
        "cone f64 solve",
        lambda: solve_batch(sys_, pb, cfg, X0[None], U0[None]), ["pdip"])
    gold = np.load(os.path.join(ROOT, "tests", "goldens",
                                "ref_coneThroughWall.npz"))
    T = lambda a: torch.as_tensor(a, dtype=F64, device=dev)[None]
    J = float(altro.quad_cost(sys_, pb, st.X, st.U)[0])
    J_ref = float(altro.quad_cost(sys_, pb, T(gold["X"]), T(gold["U"]))[0])
    goal = float((st.X[0, -1] - params["Xref"][-1]).abs().max())
    max_h = float(st.hx.max())
    log(f"[cone] f64: {wall:.3f} s, converged {bool(st.converged[0])}, "
        f"iters {int(st.iter[0])} (reference {int(gold['iters'])}), goal "
        f"error {goal:.3e}, max h {max_h:.3e}, cost {J:.6f} (reference "
        f"{J_ref:.6f})")
    check(bool(st.converged[0]) and goal < 1e-4 and max_h < 1e-3
          and J <= 1.001 * J_ref, "f64 cone misses its reference")
    run.solved[("coneThroughWall", F64, 0, 1, 0.0)] = (X0[None], st.X)
    run.record["cone_f64"] = {"wall_s": wall, "iters": int(st.iter[0]),
                              "goal_err": goal, "max_h": max_h, "cost": J,
                              "cost_ref": J_ref}

    # Some perturbed scenarios do not converge in f32; one can iterate past
    # 1,000 ALTRO iterations without failing, so the run caps the batch
    # (tools/hard_lanes.py's RUNS) and reports the converged count
    cap = hard_lanes.CONE_MAX_ITERS
    sys_, params_b, X0_b, U0_b, cfg = hard_lanes.system_problem(
        "coneThroughWall", F32, dev, seed=0, n=n, max_iters=cap)
    st, wall = run.path(
        "cone f32 batch",
        lambda: solve_batch(sys_, params_b, cfg, X0_b, U0_b), ["pdip"])
    stats = hard_lanes.solve_stats(sys_, params_b, st)
    check(stats["finite"], "f32 cone batch: non-finite states or controls")
    conv = st.converged
    it_conv = st.iter.double()[conv]
    log(f"[cone] f32 batch {n}, at most {cap} iterations: "
        f"{wall:.3f} s wall, converged {stats['converged']}/{n} "
        f"{stats['scenarios_converged']}, failed {stats['failed']}, capped "
        f"{int((~conv & ~st.failed).sum())}; iterations of the converged: "
        f"mean {float(it_conv.mean()):.3f}, max "
        f"{int(it_conv.max()) if len(it_conv) else -1}; cold "
        f"re-check of the converged: max h = 1 - alpha {stats['max_h']:.3e}")
    log(f"[cone] f32 per scenario: iters {st.iter.tolist()}, convio "
        f"{[float(f'{v:.3g}') for v in st.convio.tolist()]}")
    run.record["cone_f32_batch"] = {
        "wall_s": wall, "n": n, "max_iters_cap": cap,
        "converged": stats["converged"], "failed": stats["failed"],
        "scenarios_converged": stats["scenarios_converged"],
        "iters": st.iter.tolist(), "convio": st.convio.tolist(),
        "rho": st.rho.tolist(), "max_h_converged": stats["max_h"]}
    # their trajectories graze the walls whether they converged or not
    run.solved[("coneThroughWall", F32, 0, n, 0.02)] = (X0_b, st.X)


# -- 8. MPC -----------------------------------------------------------------

def phase_mpc(run):
    from dcol_tpu_torch.solver import mpc
    from dcol_tpu_torch.systems import piano_mover
    from dcol_tpu_torch.tools import hard_lanes

    dev = run.dev
    sys_, params, X0, U0, cfg = piano_mover.make_problem(F64, dev)
    cfg = dataclasses.replace(cfg, max_iters=40)
    pb = {k: v[None] for k, v in params.items()}
    res = {}
    for carry in (True, False):
        name = "warm" if carry else "cold"
        r, wall = run.path(
            f"mpc piano {name} duals",
            lambda: mpc.mpc_run(sys_, pb, cfg, X0[None, 0], U0[None], 12,
                                carry_duals=carry), ["pdip"])
        check(bool(torch.isfinite(r.X_applied).all()),
              f"piano MPC ({name}): non-finite states")
        res[name] = (r, wall)
    it_w = float(res["warm"][0].iters[0, 1:].double().mean())
    it_c = float(res["cold"][0].iters[0, 1:].double().mean())
    log(f"[mpc] f64 piano, 12 ticks: mean iterations per tick after the "
        f"first, dual-warm {it_w:.3f} ({res['warm'][1]:.3f} s) vs dual-cold "
        f"{it_c:.3f} ({res['cold'][1]:.3f} s)")
    check(it_w < it_c, "dual warm starts did not cut MPC iterations")

    # bench_mpc.py's closed loop (tools/hard_lanes.py::mpc_problem)
    n_steps = 5
    sys_, pb, cfg, x0s, Ub = hard_lanes.mpc_problem(dev)
    S, N, tick_iters = x0s.shape[0], sys_.N, cfg.max_iters
    r, wall = run.path(
        "mpc quadrotor S=128",
        lambda: mpc.mpc_run(sys_, pb, cfg, x0s, Ub, n_steps), ["pdip"])
    check(bool(torch.isfinite(r.X_applied).all()
               & torch.isfinite(r.U_applied).all()),
          "quadrotor MPC: non-finite states or controls")
    mean_it = float(r.iters.double().mean())
    h_max = float(r.h_applied.max())
    log(f"[mpc] f32 quadrotor S={S} N={N}, {n_steps} ticks x <= "
        f"{tick_iters} iterations: {wall:.3f} s wall, "
        f"{n_steps / wall:.4f} ticks/s ({S * n_steps / wall:.2f} "
        f"scenario-ticks/s), mean iterations per tick {mean_it:.3f}, "
        f"converged ticks {float(r.converged.double().mean()):.4f}, max "
        f"h_applied {h_max:.3e}, max plan convio "
        f"{float(r.convio.max()):.3e}")
    run.record["mpc"] = {
        "piano_warm_iters": it_w, "piano_cold_iters": it_c,
        "quad_wall_s": wall, "quad_ticks_per_s": n_steps / wall,
        "quad_mean_iters": mean_it, "quad_max_h_applied": h_max}
    run.mpc = (sys_, pb, r)  # phase 15 judges its closed-loop states


# -- 10. distributed + checkpoint ----------------------------------------

def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def phase_distributed(run):
    from dcol_tpu_torch.ops import nvcc_build
    from dcol_tpu_torch.parallel import checkpoint, distributed
    from dcol_tpu_torch.parallel.batch import perturb_scenarios, summarize
    from dcol_tpu_torch.solver import altro
    from dcol_tpu_torch.systems import quadrotor

    X0_ref, ref = run.main_state
    # the rows made on the host, as a process of a multi-process run holds
    # its scenarios before it scatters them to its card
    sys_, params, X0, U0, cfg = quadrotor.make_problem(F32, "cpu")
    local = perturb_scenarios(params, X0, U0, n=BATCH, seed=0, x0_sigma=0.02)
    path = os.path.join(nvcc_build.BUILD_DIR, "chip_smoke_state.npz")
    distributed.initialize(f"localhost:{free_port()}", 1, 0, run.dev)
    try:
        mesh = distributed.global_scenario_mesh()

        def go():
            shard = distributed.scatter_local(mesh, local)
            capped = distributed.solve_scattered(
                sys_, mesh, shard, dataclasses.replace(cfg,
                                                       max_iters=RESUME_CAP))
            checkpoint.save(path, capped)
            st = altro.iterate(sys_, shard.data[0], cfg,
                               checkpoint.load(path, device=run.dev))
            return shard, capped.iter.cpu(), st, distributed.gather_metrics(st)

        (shard, capped_iters, st, gm), wall = run.path(
            "distributed + checkpoint", go, ["pdip"])
    finally:
        distributed.shutdown()
    check(shard.data[1].device == run.dev and (shard.lo, shard.hi,
                                               shard.n_global)
          == (0, BATCH, BATCH), f"shard {shard.lo}:{shard.hi} of "
                                f"{shard.n_global} on {shard.data[1].device}")
    check(torch.equal(shard.data[1], X0_ref), "phase 10's scenarios differ "
                                              "from phase 4's")
    check(int(capped_iters.max()) == RESUME_CAP,
          f"capped solve ran {int(capped_iters.max())} iterations")
    ref_sum = summarize(ref)
    n_it = int((st.iter != ref.iter).sum())
    n_cv = int((st.converged != ref.converged).sum())
    bitwise = all(torch.equal(a, b) for (_, a), (_, b) in
                  zip(checkpoint.leaves(st), checkpoint.leaves(ref)))
    dX = float((st.X - ref.X).abs().max())
    mb = os.path.getsize(path) / 2**20
    log(f"[distributed] NCCL world size 1 on {run.dev}: {BATCH} scenarios "
        f"capped at {RESUME_CAP} iterations, checkpoint of {mb:.1f} MiB, "
        f"loaded and resumed: {wall:.3f} s wall (phase 4: "
        f"{run.record['main']['wall_s']:.3f} s); iteration counts differ "
        f"from phase 4 on {n_it}, converged flags on {n_cv}; max |dX| "
        f"{dX:.3e}, every leaf bitwise equal: {bitwise}")
    log(f"[distributed] gather_metrics {gm}; summarize of phase 4 {ref_sum}")
    check(n_it == 0 and n_cv == 0 and int(st.converged.sum()) == BATCH,
          "the resumed solve differs from phase 4's per scenario")
    check(gm == ref_sum, "gather_metrics differs from phase 4's summary")
    check(bitwise or dX <= 1e-4, f"max |dX| {dX} above 1e-4")
    run.record["distributed"] = {"wall_s": wall, "bitwise": bitwise,
                                 "max_dX": dX, "checkpoint_mib": mb,
                                 "gather_metrics": gm}
    os.remove(path)


# -- 11. blocked and mesh ----------------------------------------------------

def phase_blocked_mesh(run):
    from dcol_tpu_torch.parallel.batch import (
        perturb_scenarios, solve_batch, solve_batch_blocked)
    from dcol_tpu_torch.parallel.mesh import scenario_mesh, solve_batch_sharded
    from dcol_tpu_torch.systems import piano_mover

    sys_, params, X0, U0, cfg = piano_mover.make_problem(F64, run.dev)
    pb, xb, ub = perturb_scenarios(params, X0, U0, n=4, seed=5,
                                   x0_sigma=0.01)
    ref, _ = run.path("piano solve_batch x4",
                      lambda: solve_batch(sys_, pb, cfg, xb, ub), ["pdip"])
    mesh = scenario_mesh()
    out = {
        "blocked": run.path(
            "piano solve_batch_blocked block=2",
            lambda: solve_batch_blocked(sys_, pb, cfg, xb, ub, block=2),
            ["pdip"])[0],
        "sharded": run.path(
            f"piano solve_batch_sharded over {len(mesh)} device(s)",
            lambda: solve_batch_sharded(sys_, mesh, pb, cfg, xb, ub),
            ["pdip"])[0]}
    check(bool(ref.converged.all()), f"piano x4: converged "
                                     f"{ref.converged.tolist()}")
    rec = run.record["blocked_mesh"] = {"iters": ref.iter.tolist()}
    for name, st in out.items():
        err = float((st.X - ref.X).abs().max())
        log(f"[mesh] f64 piano x4, {name}: iters {st.iter.tolist()} against "
            f"{ref.iter.tolist()}, max |dX| {err:.3e}")
        check(torch.equal(st.iter, ref.iter) and err <= 1e-6,
              f"{name} differs from solve_batch")
        rec[name] = err
    try:
        solve_batch_blocked(sys_, pb, cfg, xb, ub, block=3)
    except ValueError as e:
        log(f"[mesh] block=3 raises: {e}")
    else:
        check(False, "block=3 of a batch of 4 did not raise")


# -- 12. profile ---------------------------------------------------------------

def phase_profile(run):
    from dcol_tpu_torch.tools import profile_breakdown

    res, _ = run.path("profile_breakdown batch 64",
                      lambda: profile_breakdown.run(64, run.dev, out=log),
                      ["pdip"])
    prof = res["full_iteration_profile"]
    check(all(ms > 0 for ms in res["components"].values()),
          "a component took no time")
    check(0.0 < prof["busy_share"] <= 1.0 and prof["top_ops"],
          f"busy share {prof['busy_share']} from {prof['device_ops']} "
          "device operations")
    run.record["profile"] = res


# -- 13. CLI -------------------------------------------------------------------

def phase_cli(run):
    from dcol_tpu_torch import main as cli
    from dcol_tpu_torch.systems import piano_mover

    gold = int(np.load(os.path.join(ROOT, "tests", "goldens",
                                    "ref_piano_mover.npz"))["iters"])
    rec = run.record["cli"] = {}
    for flag, dtype in (("--f64", F64), (None, F32)):
        argv = ["--system", "piano_mover", "--verbose", "--no-viz"]
        argv += [flag] if flag else []
        buf = io.StringIO()

        def go():
            with contextlib.redirect_stdout(buf):
                return cli.main(argv)

        st, wall = run.path("cli " + " ".join(argv[1:]), go, ["pdip"])
        lines = buf.getvalue().splitlines()
        for ln in lines[:1] + lines[-3:]:
            log(f"[cli] {ln}")
        n_it = int(st.iter[0])
        xref = piano_mover.make_problem(dtype, run.dev)[1]["Xref"]
        goal = float((st.X[0, -1] - xref[-1]).abs().max())
        ok = (bool(st.converged[0]) and not bool(st.failed[0])
              and f"(converged=True, iters={n_it})" in lines[-1])
        rec[str(dtype)[6:]] = {"wall_s": wall, "iters": n_it,
                               "goal_err": goal, "last": lines[-1]}
        if dtype == F64:
            # the reference's own exact pin, the golden's f64 count
            check(ok and n_it == gold, f"the CLI's f64 piano: {n_it} "
                                       f"iterations, golden {gold}")
        else:
            # by rule, not by the count the card happens to give: the
            # golden test's goal error, and the JAX package's f32 count
            # on the CPU within F32_PIANO_ITERS_ATOL
            check(ok and goal <= GOAL_ATOL
                  and abs(n_it - JAX_F32_PIANO_ITERS) <= F32_PIANO_ITERS_ATOL,
                  f"the CLI's f32 piano: converged {bool(st.converged[0])}, "
                  f"{n_it} iterations (JAX {JAX_F32_PIANO_ITERS} +- "
                  f"{F32_PIANO_ITERS_ATOL}), goal error {goal:.3e}")
    log(f"[cli] piano: f64 {rec['float64']['iters']} iterations (golden "
        f"{gold}); f32 {rec['float32']['iters']} iterations (the JAX "
        f"package's f32 count on the CPU {JAX_F32_PIANO_ITERS}, held within "
        f"+-{F32_PIANO_ITERS_ATOL}), goal error "
        f"{rec['float32']['goal_err']:.3e} (at most {GOAL_ATOL:g})")


# -- 14. latency ---------------------------------------------------------------

def phase_latency(run):
    from dcol_tpu_torch.ops import pdip_cuda
    from dcol_tpu_torch.ops.cones import ConeLayout
    from dcol_tpu_torch.parallel.batch import solve_single
    from dcol_tpu_torch.systems import piano_mover
    from dcol_tpu_torch.tools import probe_latency

    dev = run.dev
    rec = run.record["latency"] = {}
    prob = probe_latency.problem(dev)
    sys_, _, _, _, cfg = prob
    scen = probe_latency.scenario(prob, probe_latency.WARM_SEED)
    name = "latency solve_single"
    st, wall = run.path(name, lambda: probe_latency.solve_one(prob, scen),
                        ["pdip"])
    b = probe_latency.batches(pdip_cuda.tally, sys_.scene)
    check(st.X.shape == (sys_.N, sys_.nx)
          and bool(torch.isfinite(st.X).all()),
          f"X of shape {tuple(st.X.shape)} or non-finite")
    # independent check: a cold re-evaluation of the final trajectory
    pb = {k: v[None] for k, v in scen[0].items()}
    hx, _ = sys_.constraints_x_traj(pb, st.X[None])
    worst = float(hx.max())
    it = int(st.iter)
    log(f"[latency] {wall:.3f} s wall, converged {bool(st.converged)}, {it} "
        f"iterations, {b['launches']} PDIP launches = {b['batches']} "
        f"constraint batches x {b['launches_per_batch']}; cold re-check max "
        f"h {worst:.3e} (convio_tol {cfg.convio_tol:g})")
    run.log_shapes(name)
    check(bool(st.converged) and 44 <= it <= 55,
          f"converged {bool(st.converged)} in {it} iterations")
    check(b["launches_per_batch"] == 7,
          f"{b['launches_per_batch']} PDIP launches per constraint batch")
    check(worst <= cfg.convio_tol,
          f"the final trajectory collides (max h {worst:.3e})")
    rec.update(b, wall_s=wall, iters=it, max_h=worst,
               pdip_by_shape=run.record["paths"][name]["pdip_by_shape"])

    # the kernel against its plain version at the path's two batch sizes:
    # one trajectory (cold and polish batches, B = N n_g) and 4 line-search
    # candidates (B = 4 N n_g) between the scenario's initial and final
    # trajectories, on that scenario's obstacles
    scene, opts = sys_.scene, sys_.scene.opts
    kw = dict(tol=opts.tol, max_iters=opts.max_iters, jitter=opts.jitter)
    X0 = scen[1]
    cands = torch.stack([X0 + a * (st.X - X0) for a in (1.0, 0.5, 0.25,
                                                         0.125)])
    rec["pdip"] = []
    for X in (cands[:1], cands):
        rs, ps = sys_.robot_pose(X)
        obs = (pb["obs_r"][:, None], pb["obs_p"][:, None])
        for (lay, idx), (c, G, h) in zip(scene.groups,
                                         scene.assemble_groups(rs, ps, *obs)):
            cl = ConeLayout(lay.n_ort, lay.s1, lay.s2)
            c, G, h = (a.reshape((-1,) + a.shape[3:]).contiguous()
                       for a in (c, G, h))
            row = compare_pdip(
                f"latency obstacles {idx}", c, G, h, cl, kw,
                capture=f"pdip_far_obstacles_{'_'.join(map(str, idx))}"
                        f"_B{c.shape[0]}")
            row["layout"] = [lay.nv, cl.n_ort, cl.s1, cl.s2]
            rec["pdip"].append(row)
            log(f"[latency] PDIP kernel vs plain, obstacles {idx} nv={lay.nv} "
                f"{cl} B={c.shape[0]}: {describe(row)}")
    rec["max_abs_err"] = max(r["max_abs_err"] for r in rec["pdip"])

    # the reference-compatible forward-difference Jacobians on the card
    sys_p = piano_mover.make_system(fd_jacobians=True)
    _, params_p, X0_p, U0_p, cfg_p = piano_mover.make_problem(F64, dev)
    stp, wall = run.path(
        "piano fd_jacobians solve_single",
        lambda: solve_single(sys_p, params_p, cfg_p, X0_p, U0_p), ["pdip"])
    gp = np.load(os.path.join(ROOT, "tests", "goldens", "ref_piano_mover.npz"))
    perr = float(np.abs(stp.X.cpu().numpy() - gp["X"]).max())
    log(f"[latency] f64 piano, fd_jacobians=True: {wall:.3f} s, converged "
        f"{bool(stp.converged)}, iters {int(stp.iter)} (golden "
        f"{int(gp['iters'])}), max |X - X_golden| {perr:.3e}")
    check(bool(stp.converged) and int(stp.iter) == int(gp["iters"])
          and perr < 1e-3, "the FD-Jacobian piano misses its golden")
    rec["piano_fd"] = {"wall_s": wall, "iters": int(stp.iter),
                       "max_dX_golden": perr}


# -- 15. hard lanes -------------------------------------------------------------

def phase_hard_lanes(run):
    from dcol_tpu_torch.ops import pdip_cuda
    from dcol_tpu_torch.ops.pdip import solve_socp
    from dcol_tpu_torch.parallel.batch import perturb_scenarios, solve_batch
    from dcol_tpu_torch.systems import piano_mover
    from dcol_tpu_torch.tools import hard_lanes, replicas

    dev = run.dev
    rec = run.record["hard_lanes"] = {}
    # the near-contact fixture: the kernel ends its far lane near tol (mu <
    # 10 tol), alone and in its place in the batch, with alpha within 1e-4
    # of the f64 solve's
    fx = hard_lanes.load_fixture(dev)
    c, G, h, cl, kw, lane = (fx[k] for k in ("c", "G", "h", "lay", "kw",
                                              "lane"))
    border = hard_lanes.BORDER * kw["tol"]
    one = tuple(a[lane:lane + 1].contiguous() for a in (c, G, h))
    r64 = solve_socp(*(a.double() for a in one), cl, **hard_lanes.F64_KW)
    check(bool(r64.converged[0]), "hard lanes: the f64 solve did not converge")
    a64 = float(r64.x[0, 3])
    outs, _ = run.path("hard lanes fixture", lambda: {
        "alone": (pdip_cuda.solve_socp_cuda(*one, cl, **kw), 0),
        "in place": (pdip_cuda.solve_socp_cuda(c, G, h, cl, **kw), lane)},
        ["pdip"])
    for where, (o, i) in outs.items():
        mu = float((o.s[i].double() * o.z[i]).sum()) / cl.degree
        err = abs(float(o.x[i, 3]) - a64)
        log(f"[hard] fixture lane {lane} {where}: converged "
            f"{bool(o.converged[i])} in {int(o.iters[i])} steps, mu "
            f"{mu:.3e} (tol {kw['tol']:g}), |alpha - f64| {err:.3e}")
        rec[f"fixture {where}"] = {"converged": bool(o.converged[i]),
                                   "iters": int(o.iters[i]), "mu": mu,
                                   "alpha_err_f64": err}
        check(mu < border and err <= HARD_ALPHA_ATOL,
              f"the kernel misses the fixture lane {where}")
    rec["alpha_f64"] = a64

    # the lane's trace by max_iters, kernel and plain version on the card
    rec["trace"] = {"kernel": hard_lanes.fixture_traces(
        pdip_cuda.solve_socp_cuda, fx), "plain": hard_lanes.fixture_traces(
        solve_socp, fx)}
    for name, traces in rec["trace"].items():
        for where, t in traces.items():
            log(f"[hard] trace, {name} {where}: {t['end']}; (max_iters, "
                f"steps, mu) " + " ".join(f"{k}:{it}:{mu:.2e}"
                                          for k, it, mu in t["rows"][7:16]))
            check(name == "plain" or t["rows"][-1][2] < border,
                  f"hard lanes: the kernel's trace {where} {t['end']}")

    # the class: the near-contact batches of every solve the smoke made
    # (phase 4's quadrotor and f64 piano, phase 7's f64 cone and f32 cone
    # batch, the f32 piano solved here as the CLI solves it, and the f32
    # piano's batch of 64 of benchmarks/bench_systems.py at seed 0, the one
    # f32 layout the kernel iterates in f32), each judged by the rule of its
    # dtype (tools/hard_lanes.py::judge); phase 8's MPC closed-loop states;
    # and the lanes captured from the quadrotor's
    # (tests/torch_fixtures/pdip_hard_lane_*.npz)
    t0 = time.perf_counter()
    sys_p, pb, xb, ub, cfg = hard_lanes.system_problem(
        "piano_mover", F32, dev, seed=0, n=1, sigma=0.0)
    stp, wall = run.path("hard lanes f32 piano solve_batch",
                         lambda: solve_batch(sys_p, pb, cfg, xb, ub), ["pdip"])
    log(f"[hard] f32 piano, nominal solve_batch: {wall:.3f} s, converged "
        f"{bool(stp.converged[0])}, iters {int(stp.iter[0])}")
    check(bool(stp.converged[0]), "hard lanes: the f32 piano did not converge")
    run.solved[("piano_mover", F32, 0, 1, 0.0)] = (xb, stp.X)
    n, sigma = hard_lanes.SYSTEMS_BATCH, hard_lanes.PIANO_SIGMA
    sys_p, pb, xb, ub, cfg = hard_lanes.system_problem(
        "piano_mover", F32, dev, seed=0, n=n, sigma=sigma)
    stp, wall = run.path(f"hard lanes f32 piano solve_batch x{n}",
                         lambda: solve_batch(sys_p, pb, cfg, xb, ub), ["pdip"])
    stats = hard_lanes.solve_stats(sys_p, pb, stp)
    log(f"[hard] f32 piano, {n} scenarios at sigma {sigma:g}, seed 0 "
        f"(bench_systems.py's batch): {wall:.3f} s, converged "
        f"{stats['converged']}/{n}, mean iters {stats['mean_iters']:.4f}, "
        f"max {stats['max_iters']}; cold re-check max h "
        f"{stats['max_h']:.3e}, goal error {stats['goal_err']:.3e}")
    run.log_shapes(f"hard lanes f32 piano solve_batch x{n}")
    rec["piano_batch"] = dict(stats, wall_s=wall)
    piano_missed = hard_lanes.piano_failures(stats, 0)
    check(not piano_missed, f"hard lanes: the f32 piano's batch of {n} "
                            f"misses its guards: {piano_missed}")
    run.solved[("piano_mover", F32, 0, n, sigma)] = (xb, stp.X)

    # replicated scenarios (tools/replicas.py): bench_systems.py's cone
    # batch, its nominal problem x 64 capped at 80 (hard_lanes.cone_failures:
    # every member converged in equal iterations, X bitwise equal), then 3
    # ALTRO iterations of the main path's batch of 128 and the piano's of
    # 64, each scenario replicated, every state field equal across members
    n, sigma = hard_lanes.SYSTEMS_BATCH, hard_lanes.CONE_SIGMA
    sys_c, pb, xb, ub, cfg = hard_lanes.system_problem(
        "coneThroughWall", F32, dev, seed=0, n=n, sigma=sigma,
        max_iters=hard_lanes.CONE_MAX_ITERS)
    stc, wall = run.path(f"hard lanes f32 cone solve_batch x{n}",
                         lambda: solve_batch(sys_c, pb, cfg, xb, ub), ["pdip"])
    stats = hard_lanes.solve_stats(sys_c, pb, stc)
    nX, dX = replicas.parted(stc.X)
    log(f"[hard] f32 cone, its nominal problem x{n} (bench_systems.py's "
        f"batch): {wall:.3f} s, converged {stats['converged']}/{n}, "
        f"iterations {sorted(set(stats['iters']))} (JAX "
        f"{hard_lanes.CONE_JAX_MEAN_ITERS}), X parted in {nX} members (max "
        f"{dX:.3e}); cold re-check max h {stats['max_h']:.3e}, goal error "
        f"{stats['goal_err']:.3e}")
    rec["cone_replicas"] = dict(stats, wall_s=wall, X_parted=nX, max_dX=dX)
    cone_missed = hard_lanes.cone_failures(stats)
    check(not cone_missed, f"hard lanes: the f32 cone's replicated batch of "
                           f"{n} misses its guards: {cone_missed}")
    run.solved[("coneThroughWall", F32, 0, n, sigma)] = (xb, stc.X)
    for name in ("quadrotor x128", "piano x64"):
        e = dataclasses.replace(next(x for x in replicas.SWEEP
                                     if x.name == name),
                                iters=REPLICA_ITERATIONS)
        row, _ = run.path(f"replicas {e.name}, {e.iters} iterations",
                          lambda: replicas.run_entry(e, dev, log), ["pdip"])
        rec[f"replicas {e.name}"] = row
        check(not row["failures"], f"replicas {e.name}: {row['failures']}")
    rec["near_contact"], missed = {}, []
    for (system, dtype, seed, n, sigma), (X0_s, X_s) in run.solved.items():
        label = f"{system} {str(dtype)[6:]} x{n}"
        sys_s, pb, xb, X = hard_lanes.system_state(
            system, dtype, dev, seed=seed, n=n, sigma=sigma, solved=X_s)
        check(torch.equal(xb, X0_s), f"hard lanes: the {label} scenarios "
                                     f"differ from its solve's")
        batches = hard_lanes.near_contact_batches(sys_s, pb, xb, X)
        k_out, _ = run.path(f"hard lanes near-contact batches, {label}",
                            lambda: hard_lanes.outputs(
                                pdip_cuda.solve_socp_cuda, batches), ["pdip"])
        res = hard_lanes.compare(batches, hard_lanes.outputs(solve_socp,
                                                             batches), k_out)
        for r in res["batches"]:
            for row in r["lanes"]:
                log(f"[hard]   {label} {r['batch']} B={r['B']:,} "
                    + hard_lanes.describe_lane(row))
        log(f"[hard] near-contact batches of the {label} solve ({n} "
            f"scenario(s), seed {seed}): {len(batches)} batches, "
            + hard_lanes.describe_totals(res["totals"]))
        rec["near_contact"][label] = res
        missed += [f"{label}: {m}"
                   for m in hard_lanes.verdict_failures(res["totals"])]
    sys_m, pb_m, r_m = run.mpc
    (_, res), _ = run.path(
        "hard lanes MPC X_applied batches",
        lambda: hard_lanes.judge_mpc(sys_m, pb_m, r_m,
                                     pdip_cuda.solve_socp_cuda), ["pdip"])
    for r in res["batches"]:
        for row in r["lanes"]:
            log(f"[hard]   MPC {r['batch']} B={r['B']:,} "
                + hard_lanes.describe_lane(row))
    log(f"[hard] cold batches at phase 8's MPC closed-loop states "
        f"({tuple(r_m.X_applied.shape[:2])} scenarios x states): "
        f"{len(res['batches'])} batches, "
        + hard_lanes.describe_totals(res["totals"])
        + f"; h from the kernel's cold alphas max {res['h_cold_max']:.3e}, "
        f"max |h - h_applied| {res['h_max_abs_diff']:.3e}")
    rec["near_contact"]["mpc X_applied"] = res
    missed += [f"MPC X_applied: {m}"
               for m in hard_lanes.verdict_failures(res["totals"])]
    captured, _ = run.path("hard lanes captured", lambda: {
        os.path.basename(p): hard_lanes.judge_captured(
            pdip_cuda.solve_socp_cuda, hard_lanes.load_lane(p, dev))
        for p in hard_lanes.captured_lanes()}, ["pdip"])
    # the open lanes (pdip_open_lane_*.npz), which this kernel is known to
    # stop far on (ROADMAP Queue C): judged and reported, not gated
    rec["open"] = {os.path.basename(p): hard_lanes.judge_captured(
        pdip_cuda.solve_socp_cuda, hard_lanes.load_lane(p, dev))
        for p in hard_lanes.captured_lanes(hard_lanes.OPEN)}
    for key, lanes in (("captured", captured), ("open", rec["open"])):
        for name, v in lanes.items():
            for where, w in v.items():
                log(f"[hard] {key} {name}, kernel {where}: mu "
                    f"{w['mu']:.3e}, alpha {w['alpha']:.7f}, failing "
                    f"{len(w['failing'])}")
    extra = time.perf_counter() - t0
    log(f"[hard] near-contact gate over {len(run.solved)} solves and "
        f"{len(captured)} captured lanes: {extra:.1f} s")
    rec.update(captured=captured, near_contact_s=extra)
    check(not missed, f"hard lanes: the near-contact batches fail: {missed}")
    for name, v in captured.items():
        for where, w in v.items():
            check(not w["failing"] and not w["count_short"],
                  f"hard lanes: captured {name} fails the rule {where}")

    # NaN isolation inside a launch: member 9 of each obstacle group of
    # phase 3's batch with a NaN c in one launch and a NaN G in another,
    # cold, warm and warm+skip (even members skipped); the member ends not
    # converged, every other member bitwise as in the launch without it
    def nan_launches():
        rows = []
        for idx, gcl, gc, gG, gh, gkw in run.xref_batches:
            base = pdip_cuda.solve_socp_cuda(gc, gG, gh, gcl, **gkw)
            warm = (base.x, base.s, base.z)
            G2, h2 = gG * (1 + 1e-3), gh * (1 + 1e-3)
            skip = torch.arange(gc.shape[0], device=dev) % 2 == 0
            for start, args, extra in (
                    ("cold", (gc, gG, gh), {}),
                    ("warm", (gc, G2, h2), {"warm": warm}),
                    ("warm+skip", (gc, G2, h2), {"warm": warm,
                                                 "skip": skip})):
                clean = pdip_cuda.solve_socp_cuda(*args, gcl, **gkw, **extra)
                for k in (0, 1):  # c, then G
                    bad = [a.clone() for a in args]
                    bad[k][NAN_MEMBER] = float("nan")
                    out = pdip_cuda.solve_socp_cuda(*bad, gcl, **gkw, **extra)
                    rows.append((idx, start, "cG"[k], clean, out))
        return rows

    rows, wall = run.path("hard lanes NaN launches", nan_launches, ["pdip"])
    for idx, start, field, clean, out in rows:
        keep = torch.arange(clean.x.shape[0], device=dev) != NAN_MEMBER
        check(not bool(out.converged[NAN_MEMBER]),
              f"NaN {field} of member {NAN_MEMBER}, obstacles {idx}, {start}: "
              f"converged")
        for name, a, b in zip(out._fields, out, clean):
            check(torch.equal(a[keep], b[keep]),
                  f"NaN {field} of member {NAN_MEMBER}, obstacles {idx}, "
                  f"{start}: the other members' {name} moved")
    log(f"[hard] NaN isolation: {len(rows)} poisoned launches over "
        f"{len(run.xref_batches)} obstacle groups (cold, warm, warm+skip; "
        f"a NaN c, then a NaN G in member {NAN_MEMBER}) in {wall:.3f} s: "
        f"member {NAN_MEMBER} not converged, every other member bitwise "
        f"equal to its clean launch")
    rec["nan_launches"] = len(rows)

    # one poisoned scenario in a batch (tests/test_robustness.py:39)
    sys_p, params_p, X0_p, U0_p, cfg_p = piano_mover.make_problem(F64, dev)
    pb, xb, ub = perturb_scenarios(params_p, X0_p, U0_p, n=4, seed=3,
                                   x0_sigma=0.03)
    xp = xb.clone()
    xp[2, 0, 0] = float("nan")
    clean, _ = run.path("piano x4 seed 3",
                        lambda: solve_batch(sys_p, pb, cfg_p, xb, ub),
                        ["pdip"])
    bad, wall = run.path("piano x4 seed 3, scenario 2 poisoned",
                         lambda: solve_batch(sys_p, pb, cfg_p, xp, ub),
                         ["pdip"])
    log(f"[hard] f64 piano x4, X0[2, 0, 0] = NaN: {wall:.3f} s; clean "
        f"iterations {clean.iter.tolist()}, converged "
        f"{clean.converged.tolist()}; poisoned iterations "
        f"{bad.iter.tolist()}, converged {bad.converged.tolist()}, failed "
        f"{bad.failed.tolist()}")
    check(bool(clean.converged.all()), "the clean piano batch did not converge")
    check(not bool(bad.converged[2]) and bool(bad.failed[2]),
          "the poisoned piano scenario did not fail")
    for i in (0, 1, 3):
        check(bool(bad.converged[i]) and int(bad.iter[i]) == int(clean.iter[i])
              and torch.equal(bad.X[i], clean.X[i])
              and torch.equal(bad.U[i], clean.U[i]),
              f"piano scenario {i} moved when scenario 2 was poisoned")
    rec["piano_poisoned"] = {"clean_iters": clean.iter.tolist(),
                             "poisoned_iters": bad.iter.tolist(),
                             "failed": bad.failed.tolist()}


def main():
    # -- 1. device -----------------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda is not available; this run needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"[device] {smi}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}: "
        f"{kind}, {torch.cuda.device_count()} device(s)")
    dev = torch.device(DEVICE)
    torch.cuda.set_device(dev)
    import dcol_tpu_torch  # noqa: F401  (sets full-f32 matmul precision)

    run = Run(dev, smi)
    t0 = time.perf_counter()
    for phase in (phase_build, phase_pdip, phase_quadrotor, phase_roofline,
                  phase_proximity, phase_cone, phase_mpc, phase_distributed,
                  phase_blocked_mesh, phase_profile, phase_cli,
                  phase_latency, phase_hard_lanes):
        t = time.perf_counter()
        phase(run)
        log(f"[phase] {phase.__name__[6:]}: {time.perf_counter() - t:.1f} s")
    run.record["total_s"] = time.perf_counter() - t0

    # -- 9. results --------------------------------------------------------
    fma = run.record["fma_peak"]["float32"]
    pdip = run.record["pdip"]
    pdip_err = max(pdip["max_abs_err"], run.record["latency"]["max_abs_err"])
    kernels = {"kernels": [
        {"name": "pdip", "route": "cuda",
         "source": "dcol_tpu_torch/csrc/pdip.cu", "replaces": PDIP_TPU_KERNEL,
         "launches": run.launches("pdip"), "max_abs_err": pdip_err,
         "ms": pdip["ms"], "plain_ms": pdip["plain_ms"],
         "bound_ms": pdip["bound_ms"], "bound_by": pdip["bound_by"],
         "library_ms": None},
        {"name": "fma_peak", "route": "cuda",
         "source": "dcol_tpu_torch/csrc/fma_peak.cu",
         "replaces": FMA_TPU_KERNEL, "launches": run.launches("fma_peak"),
         "max_abs_err": fma["max_abs_err"], "ms": fma["ms"],
         "plain_ms": fma["plain_ms"], "bound_ms": fma["bound_ms"],
         "bound_by": fma["bound_by"], "library_ms": None}]}
    run.record["kernels"] = kernels["kernels"]
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(run.record, f, indent=1)
    log(f"[device] {smi}")
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

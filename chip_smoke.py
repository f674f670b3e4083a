"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a nonzero exit:

  1. device: require CUDA; print the card's name and power limit;
  2. build: compile every PDIP kernel specialisation the run uses (nvcc,
     sm_90a) and print the build seconds and the ptxas register/spill report;
  3. kernel vs its plain PyTorch version on the card, on the quadrotor
     constraint batch at Xref for 128 scenarios (7 obstacle groups, 140,800
     problems; cold, warm, warm+skip, f32) and on the golden pair batch (f64,
     against tests/goldens/pairs.json); times from CUDA events;
  4. the main path: the f32 quadrotor (N=100, 11 obstacles) solved for 128
     perturbed scenarios through the kernel, checked for convergence and,
     independently, for collision-free final trajectories; then the f64 piano
     mover against its golden trajectory;
  5. a JSON line of kernel results, then the last line
     {"ok": true, "device": {...}}.

A detailed record goes to chiprun_out/chip_smoke.json.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
BATCH = 128
DEVICE = "cuda:0"
TPU_KERNEL = "dcol_tpu/ops/pdip_pallas.py:464"


def log(*a):
    print(*a, flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def cuda_ms(fn, reps=3):
    """Mean device time of fn() over reps runs, after one warm-up run."""
    fn()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def golden_batch(dtype, device):
    """The sphere-robot golden pairs padded to one layout (the batch of
    tests/test_pdip_pallas.py) and their reference alphas."""
    from dcol_tpu_torch.geometry import assembly, primitives as prim
    from dcol_tpu_torch.ops.cones import ConeLayout

    with open(os.path.join(ROOT, "tests", "goldens", "pairs.json")) as f:
        cases = [c for c in json.load(f) if c["k1"] == "sphere"]
    A, b = prim.n_sided_polygon(5, 0.6)
    shapes = {
        "polytope": prim.rect_prism(2.5, 0.15, 0.01),
        "sphere": prim.sphere(0.8),
        "cone": prim.cone(2.0, np.deg2rad(22)),
        "capsule": prim.capsule(0.2, 5.0),
        "cylinder": prim.cylinder(0.6, 3.0),
        "polygon": prim.polygon(A, b, 0.2),
    }
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
    from dcol_tpu_torch.ops import pdip_cuda
    from dcol_tpu_torch.ops.cones import ConeLayout
    from dcol_tpu_torch.ops.pdip import solve_socp
    from dcol_tpu_torch.parallel.batch import perturb_scenarios, solve_batch
    from dcol_tpu_torch.solver import altro
    from dcol_tpu_torch.systems import piano_mover, quadrotor

    record = {"device": smi, "torch": torch.__version__}

    # -- 2. build --------------------------------------------------------------
    f32 = torch.float32
    sys_, params, X0, U0, cfg = quadrotor.make_problem(f32, dev)
    scene = sys_.scene
    groups = [(lay, idx, ConeLayout(lay.n_ort, lay.s1, lay.s2))
              for lay, idx in scene.groups]
    check(len(groups) == 7, f"quadrotor has {len(groups)} groups, not 7")
    gc, gG, gh, glay, gold = golden_batch(torch.float64, dev)
    piano = piano_mover.make_system()
    specs = [(f32, lay.nv, cl) for lay, _, cl in groups]
    specs.append((torch.float64, gG.shape[-1], glay))
    specs += [(torch.float64, lay.nv, ConeLayout(lay.n_ort, lay.s1, lay.s2))
              for lay, _ in piano.scene.groups]
    t0 = time.perf_counter()
    builds = pdip_cuda.build_all(specs)
    build_wall = time.perf_counter() - t0
    log(f"[build] {len(builds)} specialisations in {build_wall:.2f} s wall")
    record["build_wall_s"] = build_wall
    record["builds"] = []
    for b in builds:
        dt, nv, n_ort, s1, s2 = b.key
        name = f"{str(dt)[6:]} nv={nv} n_ort={n_ort} s1={s1} s2={s2}"
        secs = "cached" if b.seconds is None else f"{b.seconds:.2f} s"
        log(f"[build] {name}: {secs}")
        for ln in b.ptxas:
            log(f"[build]   {ln}")
        record["builds"].append({"spec": name, "seconds": b.seconds,
                                 "ptxas": list(b.ptxas)})

    # -- 3. kernel vs plain version -----------------------------------------
    params_b, X0_b, U0_b = perturb_scenarios(params, X0, U0, n=BATCH, seed=0,
                                             x0_sigma=0.02)
    rs, ps = sys_.robot_pose(params_b["Xref"])
    grouped = scene.assemble_groups(rs, ps, params_b["obs_r"][:, None],
                                    params_b["obs_p"][:, None])
    opts = scene.opts
    kw = dict(tol=opts.tol, max_iters=opts.max_iters, jitter=opts.jitter)
    n_total, max_err, ms_total, plain_total = 0, 0.0, 0.0, 0.0
    record["groups"] = []
    for (lay, idx, cl), (c, G, h) in zip(groups, grouped):
        B = c.shape[0] * c.shape[1] * c.shape[2]
        c, G, h = (a.reshape((B,) + a.shape[3:]).contiguous()
                   for a in (c, G, h))
        n_total += B
        row = {"layout": [lay.nv, cl.n_ort, cl.s1, cl.s2], "B": B}
        ref = solve_socp(c, G, h, cl, **kw)
        out = pdip_cuda.solve_socp_cuda(c, G, h, cl, **kw)
        warm = (ref.x, ref.s, ref.z)
        G2, h2 = G * (1 + 1e-3), h * (1 + 1e-3)
        refw = solve_socp(c, G2, h2, cl, warm=warm, **kw)
        outw = pdip_cuda.solve_socp_cuda(c, G2, h2, cl, warm=warm, **kw)
        skip = torch.arange(B, device=dev) % 2 == 0
        refs = solve_socp(c, G2, h2, cl, warm=warm, skip=skip, **kw)
        outs = pdip_cuda.solve_socp_cuda(c, G2, h2, cl, warm=warm, skip=skip,
                                         **kw)
        torch.cuda.synchronize()
        for tag, o, r in (("cold", out, ref), ("warm", outw, refw),
                          ("warm+skip", outs, refs)):
            err = float((o.x[:, 3] - r.x[:, 3]).abs().max())
            torch.testing.assert_close(o.x[:, 3], r.x[:, 3], rtol=2e-3,
                                       atol=2e-3)
            # In f32 a lane whose mu ends just above tol froze on a
            # non-finite Newton step; which lanes do so depends on rounding,
            # so the flags of two f32 implementations cannot agree lane for
            # lane.  Hold the kernel to: no fewer converged lanes than the
            # plain version (0.1% of lanes slack), and every disagreeing lane
            # borderline on both sides (final mu < 10 tol).
            dis = o.converged != r.converged
            agree = 1.0 - float(dis.double().mean())
            n_k, n_p = int(o.converged.sum()), int(r.converged.sum())
            check(n_k >= n_p - 0.001 * B, f"{tag} {cl}: kernel converged "
                                          f"{n_k} lanes, plain {n_p}")
            mu_dis = torch.cat([(a.s[dis] * a.z[dis]).sum(-1) / cl.degree
                                for a in (o, r)])
            bad = mu_dis[~(mu_dis < 10 * opts.tol)]
            check(bad.numel() == 0, f"{tag} {cl}: lanes converged in one "
                                    f"version only, final mu {bad.tolist()}")
            it_k = float(o.iters.double().mean())
            it_p = float(r.iters.double().mean())
            check(abs(it_k - it_p) <= 0.05 * it_p,
                  f"{tag} {cl}: mean iters {it_k} vs {it_p}")
            max_err = max(max_err, err)
            row[tag] = {"max_abs_err_alpha": err, "converged_agree": agree,
                        "conv_kernel": n_k / B, "conv_plain": n_p / B,
                        "mean_iters_kernel": it_k, "mean_iters_plain": it_p}
        check(int(outs.iters[skip].max()) == 0 and
              int(refs.iters[skip].max()) == 0, "skipped lanes iterated")
        for a, b in zip(outs[:3], refs[:3]):
            check(torch.equal(a[skip], b[skip]),
                  f"skipped lanes differ from the plain version "
                  f"({float((a[skip] - b[skip]).abs().max())})")
        ms = cuda_ms(lambda: pdip_cuda.solve_socp_cuda(c, G, h, cl, **kw))
        plain = cuda_ms(lambda: solve_socp(c, G, h, cl, **kw))
        ms_total += ms
        plain_total += plain
        row.update(kernel_ms=ms, plain_ms=plain)
        record["groups"].append(row)
        log(f"[kernel] obstacles {idx} nv={lay.nv} {cl} B={B}: "
            f"alpha err cold {row['cold']['max_abs_err_alpha']:.3e} "
            f"warm {row['warm']['max_abs_err_alpha']:.3e} "
            f"skip {row['warm+skip']['max_abs_err_alpha']:.3e}; converged "
            f"kernel/plain {row['cold']['conv_kernel']:.4f}/"
            f"{row['cold']['conv_plain']:.4f} (flags agree "
            f"{row['cold']['converged_agree']:.4f}); iters "
            f"cold {row['cold']['mean_iters_kernel']:.3f}/"
            f"{row['cold']['mean_iters_plain']:.3f} warm "
            f"{row['warm']['mean_iters_kernel']:.3f}/"
            f"{row['warm']['mean_iters_plain']:.3f}; cold time kernel "
            f"{ms:.3f} ms, plain {plain:.3f} ms")
    check(n_total == BATCH * sys_.N * scene.n_obs,
          f"constraint batch has {n_total} problems")
    log(f"[kernel] cold constraint batch of {n_total} problems: kernel "
        f"{ms_total:.3f} ms, plain {plain_total:.3f} ms (sum over 7 groups)")

    gout = pdip_cuda.solve_socp_cuda(gc, gG, gh, glay, tol=1e-9, max_iters=40)
    gref = solve_socp(gc, gG, gh, glay, tol=1e-9, max_iters=40)
    torch.cuda.synchronize()
    check(bool(gout.converged.all()), "f64 golden batch did not converge")
    gerr = float(np.abs(gout.x[:, 3].cpu().numpy() - gold).max())
    np.testing.assert_allclose(gout.x[:, 3].cpu().numpy(), gold, rtol=1e-6,
                               atol=1e-8)
    check(torch.equal(gout.iters, gref.iters), "f64 golden iteration counts "
                                               "differ from the plain version")
    log(f"[kernel] f64 golden pairs: max |alpha - golden| {gerr:.3e}, "
        f"iters {gout.iters.tolist()} (plain {gref.iters.tolist()})")
    record.update(golden_f64_max_err=gerr, constraint_batch=n_total,
                  kernel_ms=ms_total, plain_ms=plain_total)

    # -- 4. the main path --------------------------------------------------
    pdip_cuda.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = solve_batch(sys_, params_b, cfg, X0_b, U0_b)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = pdip_cuda.launches
    check(launches > 0, "the main path launched no PDIP kernel")
    check(st.X.shape == (BATCH, sys_.N, sys_.nx), f"X shape {st.X.shape}")
    check(bool(torch.isfinite(st.X).all() & torch.isfinite(st.U).all()),
          "non-finite states or controls")
    n_conv = int(st.converged.sum())
    iters = st.iter.double()
    mean_it, max_it = float(iters.mean()), int(iters.max())
    log(f"[main] f32 quadrotor N={sys_.N}, batch {BATCH}: {wall:.3f} s wall, "
        f"converged {n_conv}/{BATCH}, failed {int(st.failed.sum())}, "
        f"mean iters {mean_it:.4f}, max iters {max_it}, "
        f"PDIP kernel launches {launches}")
    check(n_conv >= BATCH - 2, f"only {n_conv}/{BATCH} converged")
    check(40.0 <= mean_it <= 60.0, f"mean ALTRO iterations {mean_it}")
    # independent check of the result: a cold re-evaluation of the final
    # trajectories finds no collision on the converged scenarios
    hx, _, _ = altro.eval_constraints(sys_, params_b, st.X, st.U)
    worst = float(hx[st.converged].max())
    goal = float((st.X[st.converged, -1] - params_b["Xref"][st.converged, -1])
                 .abs().max())
    log(f"[main] cold re-check of converged trajectories: max h = 1 - alpha "
        f"{worst:.3e}, max |x_N - x_goal| {goal:.3e}")
    check(worst < 1e-3 and goal < 1e-3, "converged trajectories collide or "
                                        "miss the goal")
    record["main"] = {"wall_s": wall, "converged": n_conv, "batch": BATCH,
                      "mean_iters": mean_it, "max_iters": max_it,
                      "launches": launches, "max_h": worst}

    # the cheapest end-to-end golden: the f64 piano mover, 35 iterations
    sys_p, params_p, X0_p, U0_p, cfg_p = piano_mover.make_problem(
        torch.float64, dev)
    t0 = time.perf_counter()
    stp = solve_batch(sys_p, {k: v[None] for k, v in params_p.items()}, cfg_p,
                      X0_p[None], U0_p[None])
    torch.cuda.synchronize()
    gp = np.load(os.path.join(ROOT, "tests", "goldens", "ref_piano_mover.npz"))
    perr = float(np.abs(stp.X[0].cpu().numpy() - gp["X"]).max())
    log(f"[main] f64 piano mover: {time.perf_counter() - t0:.3f} s, "
        f"converged {bool(stp.converged[0])}, iters {int(stp.iter[0])} "
        f"(golden {int(gp['iters'])}), max |X - X_golden| {perr:.3e}")
    check(bool(stp.converged[0]) and int(stp.iter[0]) == int(gp["iters"])
          and perr < 1e-3, "piano mover misses its golden")

    # -- 5. results --------------------------------------------------------
    kernels = {"kernels": [{
        "name": "pdip", "route": "cuda",
        "source": "dcol_tpu_torch/csrc/pdip.cu", "replaces": TPU_KERNEL,
        "launches": launches, "max_abs_err": max_err, "ms": ms_total,
        "plain_ms": plain_total}]}
    record["kernels"] = kernels["kernels"]
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(record, f, indent=1)
    log(f"[device] {smi}")
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

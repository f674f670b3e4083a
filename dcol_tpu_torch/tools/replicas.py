"""Replicated scenarios: whether identical problems in one batch come out
equal.

    python -m dcol_tpu_torch.tools.replicas [--device cuda] [--replicas 64]
    python -m dcol_tpu_torch.tools.replicas --sweep [--device cuda] [--small]

A scenario's result must not depend on where it sits in the batch:
``benchmarks/bench_systems.py`` runs the cone as its nominal problem
replicated 64 times and holds every member to the same iterations and X,
bit for bit (``hard_lanes.cone_failures``).  An op that rounds a problem
by its address in the batch (a reduction over a long contiguous row, a
batched matmul) parts such replicas on the card, though not on the CPU.

Without ``--sweep``, on the f32 cone's nominal problem replicated N times:

1. the PDIP solver on each of the cone's near-contact batches (at the
   nominal initial rollout) with every problem replicated N times, cold,
   warm and warm+skip: the problems whose replicas differ in any output;
2. :func:`stages` of the first ALTRO iteration: the members parted at
   each step of it.

With ``--sweep``, each :class:`Entry` of :data:`SWEEP` (the replicated
shapes the JAX package's benchmark scripts run) replicates one f32
problem n times and solves it through the normal entry points
(``solve_batch``, ``mpc_run``): converged/n, whether the members'
iterations are equal, and the members whose X (the MPC's ``X_applied``)
parts from member 0, with the largest difference; the cone is also held
to ``hard_lanes.cone_failures``.  For an entry that parts, :func:`locate`
steps the solve one ALTRO iteration at a time to the first whose state
parts and runs :func:`stages` there.  ``--small`` runs each entry at 3
replicas, a 12-knot horizon and 2 ALTRO iterations (2 MPC ticks): the
CPU form.

Runs on the CPU too (the plain PDIP version).  The last line is the
result as JSON (exit 1 if an entry parts); the record goes to
``dcol_tpu_torch/build/replicas[_sweep]_<device>.json``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import Dict, List, Optional, Tuple

import torch

F32 = torch.float32
CONE, PIANO, QUAD, MPC = "coneThroughWall", "piano_mover", "quadrotor", "mpc"
# the AltroState fields a replica must keep equal to member 0's
FIELDS = ("X", "U", "mu", "mux", "lambd", "rho", "reg", "hx", "hu", "J",
          "iter", "converged", "failed")


@dataclasses.dataclass(frozen=True)
class Entry:
    """One replicated solve of the sweep: scenario 0 of
    ``hard_lanes.system_problem(system, seed, n=1, sigma)`` replicated
    ``n`` times (``system`` MPC: ``hard_lanes.mpc_problem``'s first
    initial state, ``ticks`` ticks).  ``iters``: the ALTRO cap (a tick's
    for the MPC; None: the system's own, the full solve); ``N``: the
    horizon (None: the system's); ``guard``: held to
    ``hard_lanes.cone_failures`` (every member converged, iterations and
    X equal)."""
    name: str
    system: str
    n: int
    iters: Optional[int] = None
    seed: int = 0
    sigma: float = 0.0
    N: Optional[int] = None
    ticks: int = 0
    guard: bool = False


def _sweep() -> Tuple[Entry, ...]:
    from dcol_tpu_torch.tools import hard_lanes as hl

    # bench.py's first solve: perturb_scenarios(seed=1, x0_sigma=0.02)
    quad = dict(seed=1, sigma=hl.PERTURB_SIGMA)
    return (
        Entry("quadrotor x128", QUAD, 128, **quad),  # bench.py:72-80
        # bench_scaling.py:42's batches; the first 5 iterations below 64
        *(Entry(f"quadrotor x{n}", QUAD, n, iters=5, **quad)
          for n in (8, 16, 32)),
        Entry("quadrotor x64", QUAD, 64, **quad),
        # bench_systems.py's batch of 64, the nominal problems
        Entry("piano x64", PIANO, hl.SYSTEMS_BATCH),
        Entry("cone x64", CONE, hl.SYSTEMS_BATCH, iters=hl.CONE_MAX_ITERS,
              guard=True),
        # bench_mpc.py's f32 quadrotor: N=40, 8 iterations a tick, S=8 (its
        # default) and 128 (chip_smoke.py phase 8's); 5 ticks
        *(Entry(f"MPC S={S}", MPC, S, iters=hl.MPC_TICK_ITERS, N=hl.MPC_N,
                ticks=5) for S in (8, hl.MPC_S)))


SWEEP = _sweep()


def small(e: Entry) -> Entry:
    """``e`` at 3 replicas, a 12-knot horizon and 2 ALTRO iterations (2
    MPC ticks)."""
    return dataclasses.replace(e, n=3, iters=2, N=12,
                               ticks=min(e.ticks, 2), guard=False)


def parted(t: torch.Tensor) -> Tuple[int, float]:
    """(members that differ from the first anywhere, the largest
    difference); NaN equals NaN."""
    same = (t == t[:1]) | (t.isnan() & t[:1].isnan())
    bad = ~same.reshape(t.shape[0], -1).all(1)
    return int(bad.sum()), float((t.double() - t[:1].double()).abs()
                                 .nan_to_num().max())


def state_parted(st) -> Dict[str, Tuple[int, float]]:
    """:func:`parted` of each of :data:`FIELDS` of an ``AltroState``."""
    return {f: parted(getattr(st, f)) for f in FIELDS}


def replicate(t: torch.Tensor, n: int) -> torch.Tensor:
    """(1, ...) -> (n, ...), dense."""
    return t.expand((n,) + t.shape[1:]).contiguous()


def problem(e: Entry, device):
    """(system, parameters, X0, U0, config) of a solve entry, replicated."""
    from dcol_tpu_torch.tools import hard_lanes

    sys_, pb, xb, ub, cfg = hard_lanes.system_problem(
        e.system, F32, device, seed=e.seed, n=1, sigma=e.sigma,
        max_iters=e.iters, N=e.N)
    return (sys_, {k: replicate(v, e.n) for k, v in pb.items()},
            replicate(xb, e.n), replicate(ub, e.n), cfg)


def _solver(device):
    from dcol_tpu_torch.ops import pdip_cuda
    from dcol_tpu_torch.ops.pdip import solve_socp

    return pdip_cuda.solve_socp_cuda if device.type == "cuda" else solve_socp


def pdip_replicas(device, n: int) -> Dict:
    """Per near-contact batch of the cone and start, the problems whose n
    replicas differ in any output of the PDIP solver of ``device``."""
    from dcol_tpu_torch.ops.pdip import solve_socp
    from dcol_tpu_torch.solver import altro
    from dcol_tpu_torch.tools import hard_lanes

    sys_, pb, xb, ub, _ = problem(Entry("cone", CONE, 1), device)
    X = altro.initial_rollout(sys_, pb, xb[:, 0], ub)
    solve, out = _solver(device), {}
    for b in hard_lanes.near_contact_batches(sys_, pb, xb, X):
        B = b["c"].shape[0]
        c, G, h = (a.repeat_interleave(n, 0) for a in (b["c"], b["G"],
                                                        b["h"]))
        base = solve_socp(c, G, h, b["lay"], **b["kw"])
        skip = (torch.arange(n * B, device=device) // n) % 2 == 0
        for start, kw, GG, hh in (
                ("cold", {}, G, h),
                ("warm", {"warm": (base.x, base.s, base.z)},
                 G * (1 + 1e-3), h * (1 + 1e-3)),
                ("warm+skip", {"warm": (base.x, base.s, base.z),
                               "skip": skip}, G * (1 + 1e-3),
                 h * (1 + 1e-3))):
            o = solve(c, GG, hh, b["lay"], **b["kw"], **kw)
            bad = torch.zeros(B, dtype=torch.bool, device=device)
            for t in o:
                t = t.reshape(B, n, -1)
                bad |= ~(t == t[:, :1]).all(-1).all(-1)
            out[f"{b['name']} {start}"] = {"B": B, "parted": int(bad.sum())}
    return out


def stages(sys_, pb, cfg, st, active=None) -> List[Tuple[str, int, float]]:
    """One ALTRO iteration from the replicated state ``st``, step by step
    in ``altro_iteration``'s order, each step from inputs that are equal
    across members: (step: output, members parted, largest difference).
    The steps: the state in; the open-loop rollout of its U; the dynamics
    Jacobians; the polish PDIP batch, the envelope tangents of its
    assembly (dG), ``lagrangian_gx`` of them, the envelope gradients and
    the constraint rows; the Riccati gains (K, d); the line search's cost
    in, then the alpha = 1 probe and each chunk of ``ls_parallel``
    candidates (rollouts, constraint values, costs), each warm-started
    from the last candidate before it as ``forward_pass`` does; the
    accepted step; the AL dual and penalty updates."""
    from dcol_tpu_torch.solver import altro
    from dcol_tpu_torch.systems.base import jvp, lagrangian_gx

    rows = []

    def put(step, **outs):
        rows.extend((f"{step}: {k}", *parted(t)) for k, t in outs.items())

    skip = None if active is None else ~active
    put("state in", **{f: getattr(st, f) for f in FIELDS})
    put("rollout", X=altro.initial_rollout(sys_, pb, st.X[:, 0], st.U))
    A, B = altro.dynamics_jacobians(sys_, pb, st.X[:, :-1], st.U)
    put("dynamics Jacobians", A=A, B=B)

    scene = sys_.scene
    S, T = st.X.shape[:2]
    rs, ps = sys_.robot_pose(st.X)
    sols, _ = scene._solve_groups_traj(rs, ps, pb["obs_r"], pb["obs_p"],
                                       st.warm, skip=skip,
                                       margin=scene.opts.polish_margin)
    xs = tuple(s.x.reshape(S, T, -1, s.x.shape[-1]) for s in sols)
    zs = tuple(s.z.reshape(S, T, -1, s.z.shape[-1]) for s in sols)
    put("polish PDIP", **{f"x{g}": x for g, x in enumerate(xs)},
        **{f"z{g}": z for g, z in enumerate(zs)})
    basis = torch.eye(6, dtype=st.X.dtype, device=st.X.device)[:, None,
                                                               None, :]
    shape6 = (6,) + rs.shape
    _, dgroups = jvp(
        lambda r_, p_: tuple(G for _, G, _ in scene.assemble_groups(
            r_, p_, pb["obs_r"][:, None], pb["obs_p"][:, None])),
        (rs.expand(shape6).contiguous(), ps.expand(shape6).contiguous()),
        (basis[..., :3].expand(shape6).contiguous(),
         basis[..., 3:].expand(shape6).contiguous()))
    first = lambda t: t.movedim(0, 1)  # members first
    put("envelope tangents", **{f"dG{g}": first(dG)
                                for g, dG in enumerate(dgroups)})
    put("lagrangian_gx", **{f"dG{g} x{g}": first(lagrangian_gx(dG, x))
                            for g, (dG, x) in enumerate(zip(dgroups, xs))})
    d_r, d_p = scene._envelope_grads(rs, ps, pb["obs_r"], pb["obs_p"], xs,
                                     zs)
    put("envelope gradients", d_r=d_r, d_p=d_p)
    hx, gx, _ = sys_.constraints_x_vg_traj(pb, st.X, warm=st.warm,
                                           skip=skip)
    put("polish constraints", h=hx, rows=gx)

    K, k, dJ, kmax = altro.backward_pass(
        sys_, pb, st.X, st.U, st.mu, st.mux, st.lambd, st.rho, st.reg,
        warm=st.warm, skip=skip)
    put("Riccati", K=K, d=k, delta_J=dJ, kmax=kmax)

    put("line search", J_in=altro.total_cost(
        sys_, pb, st.X, st.U, st.hx, st.hu, st.mu, st.mux, st.lambd, st.rho))
    L = cfg.max_ls_iters
    C = max(1, min(cfg.ls_parallel, max(1, L - 1)))
    n_chunks = -(-(L - 1) // C) if L > 1 else 0
    alphas = (0.5 ** torch.arange(1 + n_chunks * C, device=st.X.device)
              ).to(st.X.dtype)
    w = st.warm
    for lo, hi in [(0, 1)] + [(1 + i * C, 1 + (i + 1) * C)
                              for i in range(n_chunks)]:
        a = alphas[lo:hi]
        Cc = a.numel()
        Xn, Un = altro.rollout(sys_, pb, st.X, st.U, K, k, a.expand(S, Cc))
        hxf, wf = sys_.constraints_x_traj(
            pb, Xn.reshape(S, Cc * sys_.N, sys_.nx),
            warm=tuple(tuple(t.repeat(1, Cc, 1) for t in g) for g in w))
        hxn = hxf.reshape(S, Cc, sys_.N, -1)
        hun = sys_.constraints_u(pb, Un)
        put(f"line search alpha {float(a[0]):g}..{float(a[-1]):g}", X=Xn,
            U=Un, h=hxn, J=altro.total_cost(sys_, pb, Xn, Un, hxn, hun,
                                            st.mu, st.mux, st.lambd, st.rho))
        w = tuple(tuple(t.reshape(S, Cc, -1, t.shape[-1])[:, -1] for t in g)
                  for g in wf)
    X, U, hx, hu, J, alpha, _ = altro.forward_pass(
        sys_, pb, cfg, st.X, st.U, K, k, st.mu, st.mux, st.lambd, st.rho,
        st.hx, st.hu, st.warm, active=active)
    put("accepted step", X=X, U=U, hx=hx, J=J, alpha=alpha)
    nxt = altro.altro_iteration(sys_, pb, cfg, st, active=active)
    put("AL update", **{f: getattr(nxt, f) for f in (
        "mu", "mux", "lambd", "rho", "reg", "convio", "converged")})
    return rows


def first_parted(rows) -> Optional[str]:
    """The first step of :func:`stages` with a member parted, or None."""
    return next((name for name, n, _ in rows if n), None)


def locate(sys_, pb, cfg, st, out=print) -> Optional[Dict]:
    """From the replicated state ``st``, ALTRO iterations as
    ``altro.iterate`` runs them until one's output state parts; then
    :func:`stages` of that iteration.  None if the solve ends equal; if
    ``st`` itself parts, which of its fields do."""
    from dcol_tpu_torch.solver import altro

    if any(n for n, _ in state_parted(st).values()):
        return {"iteration": None, "state": state_parted(st)}
    i = 0
    while True:
        active = ~(st.converged | st.failed) & (st.iter < cfg.max_iters)
        if not bool(active.any()):
            return None
        nxt = altro._where(active, altro.altro_iteration(
            sys_, pb, cfg, st, active=active), st)
        if any(n for n, _ in state_parted(nxt).values()):
            rows = stages(sys_, pb, cfg, st, active)
            for name, n, d in rows:
                out(f"[replicas]     iteration {i}, {name}: {n} parted "
                    f"({d:.3e})")
            return {"iteration": i, "first": first_parted(rows),
                    "stages": rows}
        st, i = nxt, i + 1


def _mpc_locate(sys_, pb, cfg, x0s, Ub, ticks, out=print) -> Optional[Dict]:
    """The MPC's ticks one at a time (``mpc_run`` resumed) to the first
    whose carry parts; then :func:`locate` in that tick's solve."""
    from dcol_tpu_torch.solver import altro, mpc

    carry = None
    for k in range(ticks):
        r = mpc.mpc_run(sys_, pb, cfg, x0s, Ub, 1, resume_from=carry)
        if any(parted(t)[0] for t in r.final):
            x = x0s if carry is None else carry.x
            X0 = x[:, None].expand(-1, sys_.N, -1).contiguous()
            if carry is None:  # mpc_run's cold start
                st = altro.make_initial_state(sys_, pb, cfg, X0, Ub)
            else:
                st = altro.make_initial_state(sys_, pb, cfg, X0, carry.U,
                                              duals=tuple(carry[2:5]),
                                              rho=carry.rho)
            return {"tick": k, **(locate(sys_, pb, cfg, st, out)
                                  or {"solve": "equal"})}
        carry = r.final
    return None


def run_entry(e: Entry, device, out=print) -> Dict:
    """One sweep entry: its replicated solve through the normal entry
    point, the members parted, and where they part (:func:`locate`)."""
    from dcol_tpu_torch.parallel.batch import solve_batch
    from dcol_tpu_torch.solver import altro, mpc
    from dcol_tpu_torch.tools import hard_lanes

    row = dataclasses.asdict(e)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    if e.system == MPC:
        sys_, pb, cfg, x0s, Ub = hard_lanes.mpc_problem(
            device, S=e.n, N=e.N, tick_iters=e.iters)
        x0s = replicate(x0s[:1], e.n)
        r = mpc.mpc_run(sys_, pb, cfg, x0s, Ub, e.ticks)
        X, iters, conv = r.X_applied, r.iters, r.converged[:, -1]
    else:
        sys_, pb, xb, ub, cfg = problem(e, device)
        st = solve_batch(sys_, pb, cfg, xb, ub)
        X, iters, conv = st.X, st.iter, st.converged
    row["wall_s"] = time.perf_counter() - t0
    nX, dX = parted(X)
    row.update(converged=int(conv.sum()),
               iterations=sorted(set(iters.reshape(-1).tolist())),
               iters_equal=parted(iters)[0] == 0, X_parted=nX, max_dX=dX,
               failures=[])
    if e.system == MPC:
        row["fields_parted"] = {k: parted(getattr(r, k))[0] for k in (
            "U_applied", "iters", "converged", "cost", "convio",
            "h_applied", "kmax")}
    else:
        row["fields_parted"] = {k: v[0] for k, v in state_parted(st).items()}
    if e.guard:
        row["failures"] += hard_lanes.cone_failures(
            hard_lanes.solve_stats(sys_, pb, st))
    if nX or any(row["fields_parted"].values()):
        row["failures"].append(f"members parted: {row['fields_parted']}")
    what = "X_applied" if e.system == MPC else "X"
    out(f"[replicas] {e.name} ({e.system}, n={e.n}, "
        + (f"{e.ticks} ticks, " if e.system == MPC else "")
        + f"ALTRO cap {e.iters or cfg.max_iters}): {row['wall_s']:.3f} s; "
        f"converged {row['converged']}/{e.n}, iterations "
        f"{row['iterations']} (equal {row['iters_equal']}); {what} parted "
        f"in {nX} members (max {dX:.3e}); fields parted "
        f"{row['fields_parted']}")
    for f in row["failures"]:
        out(f"[replicas]   FAILS: {f}")
    if row["failures"]:
        if e.system == MPC:
            row["located"] = _mpc_locate(sys_, pb, cfg, x0s, Ub, e.ticks, out)
        else:
            row["located"] = locate(sys_, pb, cfg, altro.make_initial_state(
                sys_, pb, cfg, xb, ub), out)
        loc = row["located"] or {}
        out(f"[replicas]   located: tick {loc.get('tick')}, iteration "
            f"{loc.get('iteration')}, first step parted {loc.get('first')}")
    return row


def sweep(device="cuda", entries=SWEEP, out=print) -> Dict:
    """:func:`run_entry` of each entry; ``failures`` lists each entry's."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("replicas on the card needs CUDA")
    rows = [run_entry(e, device, out) for e in entries]
    return {"device": (torch.cuda.get_device_name(device)
                       if device.type == "cuda" else "cpu"),
            "entries": rows,
            "failures": [f"{r['name']}: {f}" for r in rows
                         for f in r["failures"]]}


def run(device="cuda", n: int = 64, out=print) -> Dict:
    """The cone's nominal problem replicated ``n`` times: the PDIP solver
    on its replicated near-contact batches, and :func:`stages` of its
    first ALTRO iteration."""
    from dcol_tpu_torch.solver import altro

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("replicas on the card needs CUDA")
    res = {"device": (torch.cuda.get_device_name(device)
                      if device.type == "cuda" else "cpu"), "replicas": n,
           "pdip": pdip_replicas(device, n)}
    out(f"[replicas] PDIP on the cone's near-contact batches x{n}, problems "
        "whose replicas differ: " + ", ".join(
            f"{k} {v['parted']}/{v['B']}" for k, v in res["pdip"].items()))
    sys_, pb, xb, ub, cfg = problem(Entry("cone", CONE, n), device)
    rows = stages(sys_, pb, cfg, altro.make_initial_state(sys_, pb, cfg, xb,
                                                          ub))
    for name, k, d in rows:
        out(f"[replicas] first iteration, {name}: {k} parted ({d:.3e})")
    res.update(stages=rows, first=first_parted(rows),
               failures=[f"{name}: {k} members parted" for name, k, _ in rows
                         if k] + [f"PDIP {k}: {v['parted']} problems parted"
                                  for k, v in res["pdip"].items()
                                  if v["parted"]])
    return res


def main(argv=None):
    from dcol_tpu_torch.ops import nvcc_build

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--replicas", type=int, default=64,
                    help="without --sweep: the cone's replica count")
    ap.add_argument("--sweep", action="store_true",
                    help="the benchmark scripts' replicated solves")
    ap.add_argument("--small", action="store_true",
                    help="with --sweep: 3 replicas, 12 knots, 2 iterations")
    args = ap.parse_args(argv)
    if args.small and not args.sweep:
        ap.error("--small goes with --sweep")
    if args.sweep:
        res = sweep(args.device, tuple(map(small, SWEEP)) if args.small
                    else SWEEP)
    else:
        res = run(args.device, args.replicas)
    os.makedirs(nvcc_build.BUILD_DIR, exist_ok=True)
    path = os.path.join(nvcc_build.BUILD_DIR, "replicas{}_{}.json".format(
        "_sweep" if args.sweep else "", torch.device(args.device).type))
    with open(path, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps({k: v for k, v in res.items() if k != "stages"}),
          flush=True)
    return res


if __name__ == "__main__":
    sys.exit(1 if main()["failures"] else 0)

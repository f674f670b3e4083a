"""Port scenario batching, sharding and checkpoints (float64 on the CPU),
mirroring tests/test_parallel.py: blocked against unblocked solves,
solve_single against a batch member, a mesh of 4 CPU devices against
solve_batch, checkpoint round trips with and without a template, a capped
solve resumed from its snapshot against an uncapped one, and snapshots
written by one package and read by the other."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dcol_tpu.parallel import checkpoint as jcheckpoint
from dcol_tpu.solver import altro as jaltro
from dcol_tpu_torch.parallel import checkpoint
from dcol_tpu_torch.parallel.batch import (perturb_scenarios, solve_batch,
                                           solve_batch_blocked, solve_single,
                                           summarize)
from dcol_tpu_torch.parallel.mesh import (scenario_mesh, shard_scenarios,
                                          solve_batch_sharded)
from dcol_tpu_torch.solver import altro
from dcol_tpu_torch.systems import piano_mover, quadrotor

torch.set_num_threads(1)

F64 = torch.float64


@pytest.fixture(scope="module")
def piano1():
    """The first of the well-conditioned f64 piano scenarios of
    tests/test_parallel.py:49-51, solved to convergence."""
    sys_, params, X0, U0, cfg = piano_mover.make_problem(F64, "cpu")
    pb, xb, ub = perturb_scenarios(params, X0, U0, n=1, seed=5,
                                   x0_sigma=0.01)
    return sys_, pb, xb, ub, cfg, solve_batch(sys_, pb, cfg, xb, ub)


@pytest.fixture(scope="module")
def piano20():
    """The cheap setting of tests/test_distributed.py, at 6 scenarios: the
    f64 piano at N=20 capped at 8 iterations, and its lock-step solve.
    (Solves to convergence cost ~10 s a block here; phase 11 of
    chip_smoke.py runs converged ones on the card.)"""
    sys_, params, X0, U0, cfg = piano_mover.make_problem(F64, "cpu", N=20)
    cfg = dataclasses.replace(cfg, max_iters=8)
    pb, xb, ub = perturb_scenarios(params, X0, U0, n=6, seed=3,
                                   x0_sigma=0.05)
    return sys_, pb, xb, ub, cfg, solve_batch(sys_, pb, cfg, xb, ub)


@pytest.fixture(scope="module")
def quad_state():
    """A 2-scenario f64 quadrotor initial state: warm holds 7 per-group
    (x, s, z) triples."""
    sys_, params, X0, U0, cfg = quadrotor.make_problem(F64, "cpu", N=10)
    pb, xb, ub = perturb_scenarios(params, X0, U0, n=2, seed=0)
    st = altro.make_initial_state(sys_, pb, cfg, xb, ub)
    assert len(st.warm) == 7
    return st


def _leaves(st):
    return [a for _, a in checkpoint.leaves(st)]


def _assert_bitwise(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_blocked_solve_matches_unblocked(piano20):
    """Blocks of 2 run the algorithm of one lock-step batch of 6: equal
    iteration counts, X to 1e-6; a block that does not divide the batch
    raises (tests/test_parallel.py:42-63); a block of the whole batch is
    solve_batch itself."""
    sys_, pb, xb, ub, cfg, full = piano20
    blocked = solve_batch_blocked(sys_, pb, cfg, xb, ub, block=2)
    np.testing.assert_array_equal(blocked.iter.numpy(), full.iter.numpy())
    np.testing.assert_allclose(blocked.X.numpy(), full.X.numpy(), rtol=0,
                               atol=1e-6)
    with pytest.raises(ValueError):
        solve_batch_blocked(sys_, pb, cfg, xb, ub, block=4)
    _assert_bitwise(solve_batch_blocked(sys_, pb, cfg, xb, ub, block=6),
                    full)


def test_solve_single_matches_batch_member(piano20):
    """solve_single is the batch of one scenario without its batch dim
    (tests/test_parallel.py:195-207): member 0's iterations, X to rtol
    1e-9."""
    sys_, pb, xb, ub, cfg, local = piano20
    one = solve_single(sys_, {k: v[0] for k, v in pb.items()}, cfg, xb[0],
                       ub[0])
    assert one.X.shape == local.X.shape[1:]
    assert int(one.iter) == int(local.iter[0])
    np.testing.assert_allclose(one.X.numpy(), local.X[0].numpy(), rtol=1e-9,
                               atol=1e-11)


def test_sharded_solve_matches_unsharded(piano20):
    """A mesh of 4 CPU devices solves 6 scenarios in contiguous shards of
    1-2; per scenario that equals solve_batch: equal iteration counts, X to
    1e-9 (tests/test_parallel.py:23-39)."""
    sys_, pb, xb, ub, cfg, local = piano20
    mesh = scenario_mesh([torch.device("cpu")] * 4)
    assert [x.shape[0] for _, x, _ in shard_scenarios(mesh, pb, xb, ub)] \
        == [1, 2, 1, 2]
    sharded = solve_batch_sharded(sys_, mesh, pb, cfg, xb, ub)
    np.testing.assert_array_equal(sharded.iter.numpy(), local.iter.numpy())
    np.testing.assert_allclose(sharded.X.numpy(), local.X.numpy(), rtol=0,
                               atol=1e-9)
    assert summarize(sharded) == summarize(local)
    with pytest.raises(ValueError):
        solve_batch_sharded(sys_, scenario_mesh(["cpu"] * 7), pb, cfg, xb,
                            ub)


def test_jvp_from_many_threads(piano20):
    """The mesh's host threads share forward-mode AD levels: 16 threads
    computing dynamics Jacobians at once, with a short switch interval,
    each get the serial result (without the lock in systems.base.jvp they
    exit each other's level and raise)."""
    import sys
    from concurrent.futures import ThreadPoolExecutor

    sys_, pb, xb, ub, cfg, local = piano20
    X, U = local.X[:, :-1], local.U
    want = altro.dynamics_jacobians(sys_, pb, X, U)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(max_workers=16) as ex:
            futs = [ex.submit(altro.dynamics_jacobians, sys_, pb, X, U)
                    for _ in range(48)]
            got = [f.result(timeout=120) for f in futs]
    finally:
        sys.setswitchinterval(old)
    for A, B in got:
        assert torch.equal(A, want[0]) and torch.equal(B, want[1])


def test_scenario_mesh_needs_cuda_or_devices():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        scenario_mesh()


@pytest.mark.parametrize("template", [True, False])
def test_checkpoint_roundtrip(tmp_path, quad_state, template):
    """save then load, with and without a template, gives back every leaf
    bitwise, the nested warm tuple and Metrics included
    (tests/test_parallel.py:66-94)."""
    path = str(tmp_path / "state.npz")
    checkpoint.save(path, quad_state)
    st = checkpoint.load(path, like=quad_state if template else None,
                         device="cpu")
    assert type(st) is altro.AltroState
    assert type(st.metrics) is altro.Metrics
    assert [len(g) for g in st.warm] == [3] * 7
    _assert_bitwise(st, quad_state)


def test_checkpoint_template_mismatch_raises(tmp_path, quad_state):
    path = str(tmp_path / "state.npz")
    checkpoint.save(path, quad_state)
    like = quad_state._replace(warm=quad_state.warm[:6])
    with pytest.raises(ValueError, match="do not match"):
        checkpoint.load(path, like=like, device="cpu")


def test_checkpoint_resume_continues(tmp_path, piano1):
    """A solve capped at 10 iterations, saved, loaded and resumed through
    the shared loop reaches the uncapped solve (tests/test_parallel.py:
    97-121): equal iterations, X to 1e-9."""
    sys_, p1, xb, ub, cfg, full = piano1
    capped = solve_batch(sys_, p1, dataclasses.replace(cfg, max_iters=10),
                         xb, ub)
    assert not bool(capped.converged[0]) and int(capped.iter[0]) == 10
    path = str(tmp_path / "partial.npz")
    checkpoint.save(path, capped)
    st = altro.iterate(sys_, p1, cfg,
                       checkpoint.load(path, like=capped, device="cpu"))
    assert bool(st.converged[0]) and int(st.iter[0]) == int(full.iter[0])
    np.testing.assert_allclose(st.X[0].numpy(), full.X[0].numpy(), rtol=0,
                               atol=1e-9)


def _to_jax(st):
    """The JAX package's AltroState holding the port state's values."""
    a = lambda t: jnp.asarray(t.numpy())
    warm = tuple(tuple(a(x) for x in g) for g in st.warm)
    fields = [a(x) if isinstance(x, torch.Tensor) else x for x in st]
    fields[altro.AltroState._fields.index("warm")] = warm
    fields[-1] = jaltro.Metrics(*(a(x) for x in st.metrics))
    return jaltro.AltroState(*fields)


def test_port_snapshot_loads_in_jax(tmp_path, quad_state):
    """The port's snapshot of a batched state loads in the JAX package's
    checkpoint.load, without a template: its structure, every leaf equal."""
    path = str(tmp_path / "port.npz")
    checkpoint.save(path, quad_state)
    jst = jcheckpoint.load(path)
    assert jax.tree_util.tree_structure(jst) == \
        jax.tree_util.tree_structure(_to_jax(quad_state))
    jl = jax.tree_util.tree_leaves(jst)
    pl = _leaves(quad_state)
    assert len(jl) == len(pl) == 19 - 2 + 21 + 7
    for j, p in zip(jl, pl):
        assert np.asarray(j).dtype == p.numpy().dtype
        np.testing.assert_array_equal(np.asarray(j), p.numpy())


@pytest.mark.parametrize("batched", [True, False])
def test_jax_snapshot_loads_in_port(tmp_path, quad_state, batched):
    """The JAX package's snapshot loads in the port's load: a batched
    (vmapped) state leaf for leaf; an unbatched one (one problem, no vmap)
    with a scenario dim of one on every leaf, the one layout the packages
    do not share (checkpoint._as_batched)."""
    ref = quad_state if batched else altro.tree_map(lambda a: a[:1],
                                                   quad_state)
    jst = _to_jax(quad_state)
    if not batched:
        jst = jax.tree_util.tree_map(lambda a: a[0], jst)
    path = str(tmp_path / "jax.npz")
    jcheckpoint.save(path, jst)
    _assert_bitwise(checkpoint.load(path, device="cpu"), ref)
    _assert_bitwise(checkpoint.load(path, like=ref, device="cpu"), ref)

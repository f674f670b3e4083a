"""The system under test: the port's entry points for one configuration.

The port (``dcol_tpu_torch``) is reached through its public modules only:
a system's ``make_system``, ``solver.altro`` (``AltroConfig``,
``make_initial_state``, ``iterate``) and ``solver.mpc.mpc_run``.  The
inputs (references, bounds, obstacle poses, initial states and controls)
are the benchmark's own (:mod:`portbench.harness.traffic`); the system
object is checked against the configuration file before it runs."""

from __future__ import annotations

import dataclasses
import importlib

import numpy as np


def _shape_mismatch(shape, want: dict) -> str:
    """What differs between a port shape and a configuration's shape."""
    if shape.kind != want["kind"]:
        return f"kind {shape.kind} != {want['kind']}"
    for k in ("R", "L", "H", "beta"):
        if not np.isclose(getattr(shape, k), want.get(k, 0.0), rtol=0,
                          atol=1e-12):
            return f"{k} {getattr(shape, k)} != {want.get(k, 0.0)}"
    for k in ("A", "b"):
        got = getattr(shape, k)
        if (got is None) != (k not in want):
            return f"{k} present in one and not the other"
        if got is not None and not np.allclose(np.asarray(got),
                                               np.asarray(want[k]), rtol=0,
                                               atol=1e-12):
            return f"{k} differs"
    return ""


class Program:
    """The port's system and solver settings for a configuration at
    horizon ``N``."""

    def __init__(self, config: dict, N: int):
        from dcol_tpu_torch.solver import altro

        kw = dict(config["port"]["make_system"], N=N)
        mod = importlib.import_module(config["port"]["module"])
        self.sys = mod.make_system(**kw)
        self.cfg = altro.AltroConfig(**config["altro"])
        s = self.sys
        got = (s.nx, s.nu, s.N, s.dt, s.scene.n_obs)
        want = (config["nx"], config["nu"], N, config["dt"],
                len(config["obstacles"]))
        if got != want:
            raise ValueError(f"the port's system has (nx, nu, N, dt, n_obs) "
                             f"{got}; the configuration states {want}")
        for name, shape, w in ([("robot", s.scene.robot, config["robot"])]
                               + [(f"obstacle {i}", o, w) for i, (o, w) in
                                  enumerate(zip(s.scene.obstacles,
                                                config["obstacles"]))]):
            bad = _shape_mismatch(shape, w)
            if bad:
                raise ValueError(f"the port's {name} differs from the "
                                 f"configuration: {bad}")

    def tick_config(self, max_iters: int):
        """The solver settings of an MPC tick: at most ``max_iters``
        iterations."""
        return dataclasses.replace(self.cfg, max_iters=max_iters)

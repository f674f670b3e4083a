"""Checkpoint / resume of the solver state as one ``.npz`` snapshot.  Port of
the npz half of ``dcol_tpu/parallel/checkpoint.py`` (its Orbax half is
JAX-only).

The snapshot holds every leaf of an :class:`~dcol_tpu_torch.solver.altro.
AltroState` (duals, penalty and regularisation, constraint caches, the
per-group PDIP warm starts and the metrics) under the JAX package's key
scheme, ``leaf_<dotted index path>``: ``leaf_0`` is X, ``leaf_9.2.1`` the s
of obstacle group 2's warm start, ``leaf_18.0`` the metrics' J.  The port's
``AltroState`` and ``Metrics`` have the JAX package's fields in its order,
and a batched state's leaves the same shapes and dtypes, so a snapshot that
either package writes of a batched state loads in the other.  The one leaf
layout that differs is the JAX package's unbatched state (one problem,
``altro.solve`` without ``vmap``): :func:`load` gives each of its leaves a
scenario dim of one (:func:`_as_batched`)."""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from dcol_tpu_torch.solver.altro import AltroState, Metrics


def leaves(tree, path=()):
    """(index path, tensor) of every leaf, in field order."""
    if isinstance(tree, tuple):
        for i, a in enumerate(tree):
            yield from leaves(a, path + (i,))
    else:
        yield path, tree


def _key(path) -> str:
    return "leaf_" + ".".join(map(str, path))


def _path(key: str):
    return tuple(int(s) for s in key[5:].split("."))


def save(path: str, state: AltroState) -> None:
    """Snapshot a (batched) solver state to ``path`` (numpy appends
    ``.npz`` if it is missing).  Each leaf is stored under its index path,
    so :func:`load` rebuilds the nested structure without a template."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez(path, **{_key(p): a.detach().cpu().numpy()
                      for p, a in leaves(state)})


def _as_batched(arrays: dict) -> dict:
    """The JAX package's unbatched snapshot (X of shape (N, nx)) with a
    scenario dim of one on every leaf; a batched one as it is."""
    if arrays[_key((0,))].ndim == 3:
        return arrays
    return {k: a[None] for k, a in arrays.items()}


def load(path: str, like: Optional[AltroState] = None, *,
         device) -> AltroState:
    """Restore a snapshot onto ``device``.  ``like``, a state of the same
    structure, gives the structure and must match the snapshot's keys;
    without it the structure (the per-group ``warm`` tuple, ``Metrics``) is
    rebuilt from the keys."""
    with np.load(path) as data:
        arrays = _as_batched({k: data[k] for k in data.files})
    leaf = lambda k: torch.as_tensor(arrays[k], device=device)
    if like is not None:
        want = sorted(_key(p) for p, _ in leaves(like))
        if sorted(arrays) != want:
            raise ValueError(f"{path}: keys {sorted(arrays)} do not match "
                             f"the template's {want}")
        ix = iter(_key(p) for p, _ in leaves(like))

        def rebuild(t):
            if isinstance(t, tuple):
                out = [rebuild(a) for a in t]
                return type(t)(*out) if hasattr(t, "_fields") else tuple(out)
            return leaf(next(ix))

        return rebuild(like)
    nested: dict = {}
    for k in arrays:
        *head, last = _path(k)
        d = nested
        for i in head:
            d = d.setdefault(i, {})
        d[last] = leaf(k)

    def to_tuple(d):
        return tuple(to_tuple(d[i]) if isinstance(d[i], dict) else d[i]
                     for i in range(len(d)))

    fields = list(to_tuple(nested))
    if len(fields) != len(AltroState._fields):
        raise ValueError(f"{path}: {len(fields)} state fields, expected "
                         f"{len(AltroState._fields)}")
    mi = AltroState._fields.index("metrics")
    fields[mi] = Metrics(*fields[mi])
    return AltroState(*fields)

"""The check that nothing the harness ran loaded JAX or the JAX package."""

from __future__ import annotations

import sys
from typing import Iterable, List

# top-level module names, compared whole: ``dcol_tpu_torch`` is not
# ``dcol_tpu``
FORBIDDEN = ("jax", "jaxlib", "flax", "dcol_tpu")


def forbidden_loaded(names: Iterable[str] = None) -> List[str]:
    """The loaded modules whose top-level name is forbidden."""
    names = sys.modules if names is None else names
    return sorted(n for n in names if n.split(".")[0] in FORBIDDEN)

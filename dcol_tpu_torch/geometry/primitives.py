"""Convex collision primitives (numpy only; the port's copy of
``dcol_tpu/geometry/primitives.py``, kept separate so the port never imports
the JAX package).

The reference implements six MRP-posed primitive *classes* with mutable pose
(``primitives/misc_primitive_constructor.py:4-88``).  Here a primitive is an
immutable description split into

  * static *shape* data (kind tag + geometry arrays/scalars, defining the
    SOCP block structure), and
  * a dynamic *pose* ``(r, p)`` passed separately to the assembly functions so
    poses can be differentiated and batched over leading dims.

Supported kinds and their conic structure (rows of the per-primitive SOCP
blocks; see ``primitives/problem_matrices.py`` in the reference):

  kind      extra vars  n_ort      n_soc
  polytope  0           n_faces    0
  sphere    0           0          4
  cone      0           1          3
  capsule   1           2          4
  cylinder  1           4          4
  polygon   2           n_faces    4

All per-kind assembly lives in :mod:`dcol_tpu_torch.geometry.assembly`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

# Kind tags (plain strings; structure is resolved statically at trace time).
POLYTOPE = "polytope"
SPHERE = "sphere"
CONE = "cone"
CAPSULE = "capsule"
CYLINDER = "cylinder"
POLYGON = "polygon"
ELLIPSOID = "ellipsoid"  # in Julia DCOL + the reference's report (§3.1.5)
                         # but never implemented in the reference Python

# Number of extra (beyond [contact(3); alpha]) decision variables per kind.
EXTRA_VARS = {
    POLYTOPE: 0,
    SPHERE: 0,
    CONE: 0,
    CAPSULE: 1,
    CYLINDER: 1,
    POLYGON: 2,
    ELLIPSOID: 0,
}

# Number of SOC rows per kind (0 means the primitive contributes no SOC).
SOC_DIM = {
    POLYTOPE: 0,
    SPHERE: 4,
    CONE: 3,
    CAPSULE: 4,
    CYLINDER: 4,
    POLYGON: 4,
    ELLIPSOID: 4,
}


@dataclasses.dataclass(frozen=True)
class Shape:
    """Static geometry of a primitive (hashable; safe to close over in jit).

    Fields mirror the attributes of the reference classes: ``A``/``b`` for
    H-representations, ``R`` radius, ``L`` length, ``H`` height, ``beta`` cone
    half-angle, plus the rigid offset ``(r_offset, Q_offset)`` applied before
    the world pose.
    """

    kind: str
    A: Optional[tuple] = None  # (n_faces, 3) for polytope, (n_faces, 2) for polygon
    b: Optional[tuple] = None  # (n_faces,)
    R: float = 0.0
    L: float = 0.0
    H: float = 0.0
    beta: float = 0.0
    r_offset: tuple = (0.0, 0.0, 0.0)
    Q_offset: tuple = ((1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0))

    # -- helpers -----------------------------------------------------------
    @property
    def n_faces(self) -> int:
        return 0 if self.A is None else len(self.A)

    @property
    def n_ort(self) -> int:
        if self.kind == POLYTOPE or self.kind == POLYGON:
            return self.n_faces
        return {SPHERE: 0, CONE: 1, CAPSULE: 2, CYLINDER: 4,
                ELLIPSOID: 0}[self.kind]

    @property
    def n_soc(self) -> int:
        return SOC_DIM[self.kind]

    @property
    def n_vars(self) -> int:
        return 4 + EXTRA_VARS[self.kind]

    def A_np(self) -> np.ndarray:
        return np.asarray(self.A, dtype=np.float64)

    def b_np(self) -> np.ndarray:
        return np.asarray(self.b, dtype=np.float64)


def _t(a) -> tuple:
    """Nested array -> nested tuple (hashable static payload)."""
    a = np.asarray(a)
    if a.ndim == 1:
        return tuple(float(v) for v in a)
    return tuple(tuple(float(v) for v in row) for row in a)


def polytope(A, b, **kw) -> Shape:
    return Shape(kind=POLYTOPE, A=_t(A), b=_t(b), **kw)


def sphere(radius: float, **kw) -> Shape:
    return Shape(kind=SPHERE, R=float(radius), **kw)


def cone(height: float, beta: float, **kw) -> Shape:
    return Shape(kind=CONE, H=float(height), beta=float(beta), **kw)


def capsule(radius: float, length: float, **kw) -> Shape:
    return Shape(kind=CAPSULE, R=float(radius), L=float(length), **kw)


def cylinder(radius: float, length: float, **kw) -> Shape:
    return Shape(kind=CYLINDER, R=float(radius), L=float(length), **kw)


def polygon(A, b, radius: float, **kw) -> Shape:
    return Shape(kind=POLYGON, A=_t(A), b=_t(b), R=float(radius), **kw)


def ellipsoid(a: float, b: float, c: float, **kw) -> Shape:
    """Axis-aligned ellipsoid with semi-axes (a, b, c) in the body frame:
    {y : ||diag(1/a,1/b,1/c) Q'(y - r)|| <= 1}.  Stored via the ``A`` slot as
    the 3x3 inverse-semi-axis matrix P^(1/2) = diag(1/a, 1/b, 1/c)."""
    import numpy as _np

    P_sqrt = _np.diag([1.0 / a, 1.0 / b, 1.0 / c])
    return Shape(kind=ELLIPSOID, A=_t(P_sqrt), **kw)


def rect_prism(length: float, width: float, height: float) -> Shape:
    """Axis-aligned rectangular prism (6-face polytope).

    Mirrors ``primitives/misc_primitive_constructor.py:91-142`` (MRP branch).
    """
    half = np.array([length / 2.0, width / 2.0, height / 2.0])
    A = np.vstack([np.eye(3), -np.eye(3)])
    b = np.concatenate([half, half])
    return polytope(A, b)


def rect_prism_mass(length: float, width: float, height: float):
    """(mass, inertia) of a unit-density rectangular prism
    (``misc_primitive_constructor.py:130-132``)."""
    mass = length * width * height
    inertia = (mass / 12.0) * np.diag(
        [width**2 + height**2, length**2 + height**2, length**2 + width**2]
    )
    return mass, inertia


def n_sided_polygon(n: int, d: float) -> tuple:
    """(A, b) H-rep of a regular 2-D n-gon with face distance d.

    Mirrors ``misc_primitive_constructor.py:145-164``.
    """
    angles = np.linspace(0.0, 2.0 * np.pi, n, endpoint=False)
    A = np.stack([np.cos(angles), np.sin(angles)], axis=1)
    b = np.full(n, d)
    return A, b


def cone_mass_properties(shape: Shape, rho: float = 1.0):
    """(mass, inertia) of a solid cone; mirrors ``primitives/mass_properties.py:3-30``."""
    r = np.tan(shape.beta) * shape.H
    V = (1.0 / 3.0) * np.pi * r**2 * shape.H
    m = V * rho
    Iyy = m * ((3.0 / 20.0) * r**2 + (3.0 / 80.0) * shape.H**2)
    Ixx = 0.3 * m * r**2
    return m, np.diag([Ixx, Iyy, Iyy])

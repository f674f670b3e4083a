"""The rollout kernel's share of its roofline in the profiled stretch: the
launches' summed bound over their summed time, in %.

Each launch is the port's note of it (``dcol_tpu_torch.utils.trace.RECORDER
.rollout_launches``, made by ``ops/rollout_cuda.py`` while a profiler
records): its system, dtype, S scenarios, C candidates, N knots, closed or
open loop, and the CUDA events recorded around it, whose elapsed time is
the launch's time.  Its bound is the larger of its FLOPs at the published
peak of its dtype and its bytes at the memory rate (``data/peaks.json``).
Bytes: each operand read once and each result written once.  FLOPs: a
lane's knot, counted from the kernel's arithmetic (below), times the
S x C lanes and the N - 1 knots.  Not read for a port without that note
(before the rollout kernel noted its launches)."""

import json
import os

with open(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "data", "peaks.json")) as _f:
    PEAKS = json.load(_f)
# the float64 rate outside the tensor cores (H100 SXM data sheet), for a
# float64 launch; the cells run float32
FLOPS_PER_S = {"float32": PEAKS["float32_flops_per_s"], "float64": 34e12}
ITEMSIZE = {"float32": 4, "float64": 8}
# system -> (nx, nu, FLOPs of one call of its continuous dynamics): the
# quadrotor's rotor clamp, torques, thrust direction, MRP kinematics and
# Euler's equations 112; the piano's one division (the rest are copies)
SYSTEMS = {"quadrotor": (12, 4, 112), "piano_mover": (6, 3, 1)}


def knot_flops(system: str, closed: bool) -> int:
    """FLOPs of one lane's knot: an RK4 step (4 dynamics calls and 17 per
    state component: the 4 stages' scalings, sums and the final update),
    and in the closed loop the feedback law u = U - K (x - X) - alpha k
    (3 per entry of K, 3 per control)."""
    nx, nu, dyn = SYSTEMS[system]
    return 4 * dyn + 17 * nx + (nu * (3 * nx + 3) if closed else 0)


def launch_bytes(system: str, dtype: str, S: int, C: int, N: int,
                 closed: bool) -> int:
    """Bytes one launch must move: the closed loop reads X (S, N, nx),
    U and k (S, N-1, nu), K (S, N-1, nu, nx) and alpha (S, C) and writes
    Xn (S, C, N, nx) and Un (S, C, N-1, nu); the open loop reads x0
    (S, nx) and U and writes X (S, N, nx)."""
    nx, nu, _ = SYSTEMS[system]
    if closed:
        n = (S * N * nx + S * (N - 1) * (2 * nu + nu * nx) + S * C
             + S * C * (N * nx + (N - 1) * nu))
    else:
        n = S * nx + S * (N - 1) * nu + S * N * nx
    return ITEMSIZE[dtype] * n


def bound_seconds(note) -> float:
    """The least time the card can take for one noted launch."""
    S, C, N, closed = note["S"], note["C"], note["N"], note["closed"]
    flops = S * C * (N - 1) * knot_flops(note["system"], closed)
    nbytes = launch_bytes(note["system"], note["dtype"], S, C, N, closed)
    return max(flops / FLOPS_PER_S[note["dtype"]],
               nbytes / PEAKS["hbm_bytes_per_s"])


def read(ctx):
    t = ctx["trace"]
    if t is None:
        return None
    try:
        from dcol_tpu_torch.utils.trace import RECORDER
    except ImportError:
        return None
    notes = getattr(RECORDER, "rollout_launches", None)
    if not notes:
        return None
    seconds = sum(1e-3 * n["start"].elapsed_time(n["end"]) for n in notes)
    if seconds <= 0:
        return None
    return 100.0 * sum(bound_seconds(n) for n in notes) / seconds

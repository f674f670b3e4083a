"""Arithmetic of a measured window, on host timestamps.

A window opens at ``t0`` and is ``seconds`` long.  A step (an ALTRO
iteration or an MPC tick) that starts inside the window is finished and
counted, and the window's time runs to its end; steps run back to back,
so a step starts where the one before it ended."""

from __future__ import annotations

from typing import List, Sequence, Tuple


def counted(t0: float, seconds: float,
            ends: Sequence[float]) -> int:
    """How many of the steps ending at ``ends`` (back to back from t0)
    started inside the window."""
    n, start = 0, t0
    for e in ends:
        if start >= t0 + seconds:
            break
        n += 1
        start = e
    return n


def rate(t0: float, seconds: float,
         steps: Sequence[Tuple[float, float]]) -> Tuple[float, float, int]:
    """(work, elapsed, steps) of the window: ``steps`` are (end time,
    work of the step), e.g. the scenarios active in an ALTRO iteration;
    elapsed runs from t0 to the end of the last step counted."""
    n = counted(t0, seconds, [e for e, _ in steps])
    if n == 0:
        return 0.0, 0.0, 0
    return (float(sum(w for _, w in steps[:n])), steps[n - 1][0] - t0, n)


def union_seconds(intervals: Sequence[Tuple[float, float]]) -> float:
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_pct(busy_s: float, wall_s: float) -> float:
    """Share of ``wall_s`` in which the device ran nothing, in %."""
    return 100.0 * (1.0 - busy_s / wall_s)


def gaps(intervals: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The (start, end) gaps between the union of intervals."""
    out, cur_e = [], None
    for s, e in sorted(intervals):
        if cur_e is not None and s > cur_e:
            out.append((cur_e, s))
        cur_e = e if cur_e is None else max(cur_e, e)
    return out

"""Reductions of a client's device trace: its operations' intervals
merged, their time by name, and the union over clients. Times are
nanoseconds on the host's wall clock (``time.time_ns``), which is the
clock of the profiler's timestamps, so that clients' traces line up."""

from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple


def merge(intervals: Iterable[Sequence[int]]) -> List[List[int]]:
    """The union of [start, end] intervals, as sorted disjoint ones."""
    out: List[List[int]] = []
    for s, e in sorted((int(a), int(b)) for a, b in intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def clip(intervals: Iterable[Sequence[int]], lo: int, hi: int
         ) -> List[List[int]]:
    """The parts of the intervals inside [lo, hi]."""
    return [[max(s, lo), min(e, hi)] for s, e in intervals
            if e > lo and s < hi]


def clip_spans(spans: Iterable[Sequence], lo: int, hi: int) -> List[list]:
    """The program's spans ([name, thread, start, end]) cut to [lo, hi]:
    the parts inside it, of those that overlap it."""
    return [[n, th, max(int(s), lo), min(int(e), hi)]
            for n, th, s, e in spans if e > lo and s < hi]


def innermost(spans: Iterable[Sequence], t: int):
    """The name of the innermost span open at `t`, over all threads: the
    latest to start (of those that started together, the first to end);
    None where none is open."""
    open_ = [(-s, e, n) for n, _, s, e in spans if s <= t <= e]
    return min(open_)[2] if open_ else None


def covered(intervals: Iterable[Sequence[int]]) -> int:
    return sum(e - s for s, e in intervals)


def gaps(intervals: Sequence[Sequence[int]], lo: int, hi: int
         ) -> List[Tuple[int, int]]:
    """The stretches of [lo, hi] that no interval covers (merged input)."""
    out, t = [], lo
    for s, e in intervals:
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(s, e) for s, e in out if e > s]


def device_ops(prof) -> List[Tuple[str, int, int]]:
    """(name, start_ns, end_ns) of every operation that ran on the card
    in a ``torch.profiler.profile`` that has stopped: kernels, copies and
    sets, each as the profiler timed it."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    out = []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != cuda:
            continue
        s = int(ev.start_ns())
        out.append((ev.name(), s, s + int(ev.duration_ns())))
    return out

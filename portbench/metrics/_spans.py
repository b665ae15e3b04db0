"""What the readers of the program's spans share: each client's
``program`` (``Decoder.trace_snapshot()``'s counters' deltas over the
window and its spans clipped to the client's trace, ``[name, thread,
start ns, end ns]``), and a set of spans' self time summed over the
clients, in ms a picture fed inside the traces (``_traced.pictures``,
the denominator of ``step_device_ms``).

A span's self time is its clipped duration less what the spans nested
in it on the same thread cover: the work of its own layer. A span whose
name ends in ``.queued`` is a job's wait in a queue, begun at its submit
on another thread and written by the thread that ran it: it is no work
of that thread, so it is taken whole, and it neither holds nor is held
by another span."""

from __future__ import annotations

from . import _traced

QUEUED = ".queued"


def programs(run: dict):
    """Every client's ``program``; None where any client sent none or
    sent no spans (a client that ran no profiler clips them all away)."""
    progs = [r.get("program") for r in run["clients"]]
    if not progs or any(not p or not p.get("spans") for p in progs):
        return None
    return progs


def self_ns(spans, names, thread: str = "") -> int:
    """The summed self time, in ns, of the spans named in `names` on the
    threads whose names start with `thread` (any thread for "")."""
    total = 0
    by_thread = {}
    for n, th, s, e in spans:
        if not th.startswith(thread):
            continue
        if n.endswith(QUEUED):
            total += (e - s) if n in names else 0
        else:
            by_thread.setdefault(th, []).append((s, e, n))
    for ivs in by_thread.values():
        ivs.sort(key=lambda v: (v[0], -v[1]))
        open_ = []                  # [end, name, start, ns its children hold]
        for s, e, n in ivs:
            while open_ and open_[-1][0] <= s:
                total += _own(open_.pop(), names)
            if open_ and e <= open_[-1][0]:
                open_[-1][3] += e - s
            open_.append([e, n, s, 0])
        while open_:
            total += _own(open_.pop(), names)
    return total


def _own(span: list, names) -> int:
    e, n, s, children = span
    return e - s - children if n in names else 0


def ms_a_picture(run: dict, names, thread: str = ""):
    """The self time of the spans named in `names` (on threads whose names
    start with `thread`), over every client, in ms a picture fed inside
    the traces; None where a client sent no spans or no picture was fed
    in them."""
    progs = programs(run)
    pics = _traced.pictures(run)
    if progs is None or not pics:
        return None
    ns = sum(self_ns(p["spans"], names, thread) for p in progs)
    return ns / 1e6 / len(pics)

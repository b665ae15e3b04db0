"""sync_blocked_share: the share, in %, of the graphs' input uploads that
found the previous upload from their staging buffers still in flight,
and so had to wait for the card (the program's counters
``graph.sync_blocked`` over ``graph.uploads``, deltas over the whole
window, summed over the clients)."""

from __future__ import annotations

from . import _spans

UNIT = "%"


def read(run: dict):
    progs = _spans.programs(run)
    if progs is None:
        return None
    uploads = sum(p["counters"].get("graph.uploads", 0) for p in progs)
    if not uploads:
        return None
    blocked = sum(p["counters"].get("graph.sync_blocked", 0) for p in progs)
    return 100.0 * blocked / uploads

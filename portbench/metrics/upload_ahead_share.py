"""upload_ahead_share: the share, in %, of the graphs' input uploads that
were made while the same graph's previous upload was still in flight:
those that a graph with one staging buffer would have held back until
the card caught up (the program's counters ``graph.upload_ahead`` over
``graph.uploads``, deltas over the whole window, summed over the
clients). None where a client sent no counters, or a program that does
not count ``graph.upload_ahead``."""

from __future__ import annotations

from . import _spans

UNIT = "%"


def read(run: dict):
    progs = _spans.programs(run)
    if progs is None or \
            any("graph.upload_ahead" not in p["counters"] for p in progs):
        return None
    uploads = sum(p["counters"].get("graph.uploads", 0) for p in progs)
    if not uploads:
        return None
    ahead = sum(p["counters"]["graph.upload_ahead"] for p in progs)
    return 100.0 * ahead / uploads

"""idle_unnamed_share: the share, in %, of the traced window's idle time
(the gaps of the union of every client's device intervals, as
``run.breakdown`` finds them) that lies in gaps that ``run.host_activity``
names ``host``: most clients had no program span open at the gap's
middle, so the spans leave that idle time unexplained."""

from __future__ import annotations

from .. import run as RUN
from .. import trace as TR
from . import _spans

UNIT = "%"

# a span open at no time: it keeps a client's list of spans non-empty,
# which is how host_activity knows that every client sent spans
_NEVER = ["", "", 1, 0]


def read(run: dict):
    progs = _spans.programs(run)
    if progs is None or run.get("union") is None:
        return None
    lo, hi = run["trace_window"]
    gaps = TR.gaps(run["union"], lo, hi)
    idle = sum(e - s for s, e in gaps)
    if not idle:
        return None
    unnamed = sum(e - s for (s, e), what in zip(gaps, _names(run, progs,
                                                             gaps))
                  if what == "host")
    return 100.0 * unnamed / idle


def _names(run: dict, progs: list, gaps: list):
    """``run.host_activity`` of each gap (in time order), asked of a view
    of the run whose clients hold only the spans open at the gap's middle:
    the same answer, without a pass over every span for every gap."""
    by_start = [sorted(p["spans"], key=lambda sp: sp[2]) for p in progs]
    nxt = [0] * len(progs)
    live = [[] for _ in progs]
    for s, e in gaps:
        mid = (s + e) // 2
        view = []
        for i, spans in enumerate(by_start):
            while nxt[i] < len(spans) and spans[nxt[i]][2] <= mid:
                live[i].append(spans[nxt[i]])
                nxt[i] += 1
            live[i] = [sp for sp in live[i] if sp[3] >= mid]
            view.append({"program": {"spans": live[i] or [_NEVER]}})
        yield RUN.host_activity({"clients": view}, s, e)

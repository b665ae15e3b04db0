"""The port's own spans and counters, for a caller that asks what inside
its threads the decode spends its time on (``Decoder.trace_snapshot``).

A span is ``(name, thread name, start ns, end ns)`` on ``time.time_ns()``,
the host's wall clock: the clock that a ``torch.profiler`` trace gives
its device timestamps on, so that both line up. Names are
``<layer>.<what>`` (``front.parse``, ``pump.job``, ``graph.sync``, ...);
the thread's name tells the feed thread, the slice pool (``bw-slice*``)
and the dispatch pump (``bw-pump*``) apart. A counter is a plain int
under a name.

The recorder is one per process, shared by every decoder in it. It is
off until the first ``snapshot()`` and stays on from then: until a
caller asks, a site costs a call and a flag test. Recording takes no
lock, makes no CUDA call and formats no string: a span is a tuple
appended to a bounded deque (atomic under the interpreter lock), whose
oldest spans go first once it holds ``MAXLEN``. A counter's update is a
read and a write of one dict entry, not atomic: two threads that count
under one name at once may lose one of the two.

At a site::

    t0 = spans.begin()
    ...                     # the work
    spans.end("front.parse", t0)

``begin`` returns 0 while recording is off, and ``end`` writes nothing
for a start of 0, so a span that began before recording was turned on is
never written. Where the work raises, its span is written only by a site
that ends it in a ``finally`` (the pump's job, a slice's parse).
"""

from __future__ import annotations

import collections
import threading
import time

MAXLEN = 1 << 17        # spans kept between two snapshots; the oldest go

# the counters, listed from the start so that every snapshot names them
COUNTERS = (
    "graph.uploads",        # uploads of a graph's inputs that had an
    #                         earlier upload of that graph before them
    "graph.sync_blocked",   # of those, the ones that found the copies out
    #                         of the staging buffer they rewrite still in
    #                         flight (the upload STAGING_DEPTH before)
    "graph.upload_ahead",   # of those, the ones made while the graph's
    #                         previous upload was still in flight: those a
    #                         graph with one staging buffer would hold back
)

_now = time.time_ns
_current_thread = threading.current_thread
_thread = threading.local()     # .name: the thread's name, read once


class Recorder:
    """Spans and counters of one process (``RECORDER``; a test makes its
    own, with a smaller `maxlen`)."""

    def __init__(self, maxlen: int = MAXLEN) -> None:
        self.on = False
        self.spans = collections.deque(maxlen=maxlen)
        self.counters = dict.fromkeys(COUNTERS, 0)

    def snapshot(self) -> dict:
        """Turn recording on (for good), and return ``{"counters": {name:
        count since recording began}, "spans": [[name, thread, start ns,
        end ns], ...]}``: the spans that ended since the previous call,
        oldest first, removed from the recorder. It pops as many as it
        counted at its start, so a span appended meanwhile waits for the
        next call."""
        self.on = True
        take = self.spans.popleft
        spans = [list(take()) for _ in range(len(self.spans))]
        return {"counters": dict(self.counters), "spans": spans}


RECORDER = Recorder()


def begin() -> int:
    """A span's start: the time now, or 0 while recording is off."""
    return _now() if RECORDER.on else 0


def end(name: str, t0: int) -> None:
    """Write the span `name` from `t0` (``begin``'s, or a start taken on
    another thread: a job's time in a queue) to now, on this thread."""
    if t0:
        try:
            thread = _thread.name
        except AttributeError:
            thread = _thread.name = _current_thread().name
        RECORDER.spans.append((name, thread, t0, _now()))


def recording() -> bool:
    return RECORDER.on


def count(name: str, n: int = 1) -> None:
    """Add `n` to the counter `name` while recording is on."""
    if RECORDER.on:
        c = RECORDER.counters
        c[name] = c.get(name, 0) + n

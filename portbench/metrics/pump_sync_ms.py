"""pump_sync_ms: the dispatch pump's wait for its graph's previous upload
(the span ``graph.sync`` on threads named ``bw-pump*``: the event
synchronize in ``core/graphs.py`` before the staging buffers are written
again, where the CUDA runtime spins by default), in ms a picture fed
inside the clients' traces, summed over the clients."""

from __future__ import annotations

from . import _spans

UNIT = "ms"


def read(run: dict):
    return _spans.ms_a_picture(run, {"graph.sync"}, "bw-pump")

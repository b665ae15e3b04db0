"""pump_enqueue_ms: the dispatch pump's work outside its waits, in ms a
picture fed inside the clients' traces, summed over the clients: the
self time, on threads named ``bw-pump*``, of ``pump.job``
(``Decoder._pump_run`` less what it calls that has a span of its own),
``graph.upload`` (the staging write and the two copies' enqueue) and
``graph.replay`` (the graph's launch, its tallies and the output's
copy)."""

from __future__ import annotations

from . import _spans

UNIT = "ms"


def read(run: dict):
    return _spans.ms_a_picture(
        run, {"pump.job", "graph.upload", "graph.replay"}, "bw-pump")

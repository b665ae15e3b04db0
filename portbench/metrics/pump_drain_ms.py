"""pump_drain_ms: the feed thread's waits for the dispatch pump to drain
(the span ``pump.drain`` on the main thread: ``Decoder._pump_flush``,
where a frame is read before its step ran, or at a flush), in ms a
picture fed inside the clients' traces, summed over the clients."""

from __future__ import annotations

from . import _spans

UNIT = "ms"


def read(run: dict):
    return _spans.ms_a_picture(run, {"pump.drain"}, "MainThread")

"""pump_queue_ms: how long a picture's job waited in the dispatch pump's
queue (the span ``pump.queued``: from its submit on the feed thread to
the start of ``Decoder._pump_run``), in ms a picture fed inside the
clients' traces, summed over the clients."""

from __future__ import annotations

from . import _spans

UNIT = "ms"


def read(run: dict):
    return _spans.ms_a_picture(run, {"pump.queued"})

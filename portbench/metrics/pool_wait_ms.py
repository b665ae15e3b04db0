"""pool_wait_ms: the feed thread's wait for a picture's slices on the
slice pool (the span ``front.pool_wait``: ``Decoder._run_deferred``), in
ms a picture fed inside the clients' traces, summed over the clients."""

from __future__ import annotations

from . import _spans

UNIT = "ms"


def read(run: dict):
    return _spans.ms_a_picture(run, {"front.pool_wait"})

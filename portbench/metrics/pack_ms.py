"""pack_ms: the pack of a parsed picture into the buffer that goes to the
card (the span ``front.pack``: ``core/packed.py`` ``pack_picture_v2``,
or ``pack_picture`` for v1), in ms a picture fed inside the clients'
traces, summed over the clients."""

from __future__ import annotations

from . import _spans

UNIT = "ms"


def read(run: dict):
    return _spans.ms_a_picture(run, {"front.pack"})

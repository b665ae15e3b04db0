"""front_parse_ms: the slice data's parse on the feed thread (the span
``front.parse``: the native parser of ``csrc/frontend.cpp``, or the
Python one, inline where the decoder has no slice pool), in ms a
picture fed inside the clients' traces, summed over the clients."""

from __future__ import annotations

from . import _spans

UNIT = "ms"


def read(run: dict):
    return _spans.ms_a_picture(run, {"front.parse"})

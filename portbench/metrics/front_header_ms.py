"""front_header_ms: the feed thread's work on a slice before its data
(self time of ``front.header``: the access-unit boundary, activation,
the slice header, the reference list, the slice group map;
``front.start_picture``: the picture's state and the DPB's slot; and
``front.submit``: the slice's parameters and its submit to the pool),
in ms a picture fed inside the clients' traces, summed over the
clients. The previous picture's pool wait and finish, which
``front.header`` holds, are not in it."""

from __future__ import annotations

from . import _spans

UNIT = "ms"


def read(run: dict):
    return _spans.ms_a_picture(
        run, {"front.header", "front.start_picture", "front.submit"})

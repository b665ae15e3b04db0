"""slice_parse_ms: the slice pool's parse of the slice data (the span
``slice.parse``: the native parser on a ``bw-slice*`` thread), wall
time, in ms a picture fed inside the clients' traces, summed over the
clients and the pool's threads. Beside ``slice_cpu_ms``, the pool's CPU
clock: where this reads well above it, the threads wait for a core or
for the interpreter lock."""

from __future__ import annotations

from . import _spans

UNIT = "ms"


def read(run: dict):
    return _spans.ms_a_picture(run, {"slice.parse"})

"""slice_cpu_ms: the CPU time of the decoder's slice pools (the
clients' Python threads other than the feed and the pump: the native
parse of ``csrc/frontend.cpp`` through ``bitstream/native.py``), in ms
a picture completed in the window."""

from __future__ import annotations

from . import _threads

UNIT = "ms"


def read(run: dict):
    return _threads.role_ms(run, "slice")

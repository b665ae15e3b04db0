"""feed_cpu_ms: the CPU time of the clients' feed threads (each
client's main thread: its loop and ``decode_nal``, that is the parse
where there is no slice pool, ``core/packed.py`` and the submit to the
pump), in ms a picture completed in the window."""

from __future__ import annotations

from . import _threads

UNIT = "ms"


def read(run: dict):
    return _threads.role_ms(run, "feed")

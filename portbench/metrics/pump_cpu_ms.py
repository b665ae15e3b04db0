"""pump_cpu_ms: the CPU time of the clients' dispatch pumps (threads
named ``bw-pump*``: ``Decoder._pump_run``, the upload and the graph's
replay of ``core/graphs.py``, and the waits on the card in them), in ms
a picture completed in the window."""

from __future__ import annotations

from . import _threads

UNIT = "ms"


def read(run: dict):
    return _threads.role_ms(run, "pump")

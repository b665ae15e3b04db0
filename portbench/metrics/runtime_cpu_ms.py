"""runtime_cpu_ms: the clients' CPU time on threads that Python did not
start (the CUDA driver's and torch's) and on Python threads that ended
inside the window: the process's CPU clock less its feed, slice and
pump threads', in ms a picture completed in the window."""

from __future__ import annotations

from . import _threads

UNIT = "ms"


def read(run: dict):
    return _threads.role_ms(run, "runtime")

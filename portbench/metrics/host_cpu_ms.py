"""host_cpu_ms: the clients' CPU time in the window (``os.times``, user
and system, every thread of the process), summed over the clients, in ms
a picture completed in the window. It counts work, not waiting."""

from __future__ import annotations

UNIT = "ms"


def read(run: dict):
    done = sum(1 for r in run["clients"] for *_, d in r["pictures"]
               if d is not None and 0.0 <= d <= run["seconds"])
    if not done:
        return None
    return 1e3 * sum(r["cpu_s"] for r in run["clients"]) / done

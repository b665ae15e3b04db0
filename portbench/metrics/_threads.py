"""What the per-thread CPU readers share: a thread role's CPU seconds
over every client (``client.thread_cpu_s``), in ms a picture completed
in the window, the denominator of ``host_cpu_ms``, so that the four
roles add up to the process's CPU a picture."""

from __future__ import annotations


def role_ms(run: dict, role: str):
    """None where no client sent ``thread_cpu_s``."""
    parts = [r["thread_cpu_s"][role] for r in run["clients"]
             if r.get("thread_cpu_s")]
    done = sum(1 for r in run["clients"] for *_, d in r["pictures"]
               if d is not None and 0.0 <= d <= run["seconds"])
    if not parts or not done:
        return None
    return 1e3 * sum(parts) / done

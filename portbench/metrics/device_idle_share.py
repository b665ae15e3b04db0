"""device_idle_share: the share, in %, of the traced window in which no
client had an operation on the card: one minus the union of every
client's ``torch.profiler`` device intervals over the window's length."""

from __future__ import annotations

from .. import trace as TR

UNIT = "%"


def read(run: dict):
    if run.get("union") is None:
        return None
    lo, hi = run["trace_window"]
    if hi <= lo:
        return None
    return 100.0 * (1.0 - TR.covered(run["union"]) / (hi - lo))

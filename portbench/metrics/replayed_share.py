"""replayed_share: the share, in %, of the per-picture steps in the
window that replayed a captured CUDA graph, by the program's own
counters (``GroupGraphs.counts``: eager, captured, replayed), summed over
the clients. Below 100 a key was met or captured inside the window.
The steps are those three routes alone: another counter in that dict is
no step."""

from __future__ import annotations

UNIT = "%"
ROUTES = ("eager", "captured", "replayed")


def read(run: dict):
    routes = [r["routes"] for r in run["clients"]]
    total = sum(x.get(k, 0) for x in routes for k in ROUTES)
    if not total:
        return None
    return 100.0 * sum(x.get("replayed", 0) for x in routes) / total

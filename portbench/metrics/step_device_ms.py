"""step_device_ms: the device time of the per-picture step, in ms a
picture: the summed time of every operation on the card in the clients'
traces, over the pictures fed inside them."""

from __future__ import annotations

from . import _traced

UNIT = "ms"


def read(run: dict):
    pics = _traced.pictures(run)
    if not pics:
        return None
    ns = sum(t for r in run["clients"]
             for _, t in (r.get("trace") or {}).get("ops", {}).values())
    if not ns:
        return None
    return ns / 1e6 / len(pics)

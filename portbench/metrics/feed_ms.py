"""feed_ms: host time of the feed, in ms a picture: the harness's span
around each ``decode_nal`` call of a picture (the parse, the pack, the
submit to the pump and any wait for it), summed over the clients, over
the pictures fed inside the window."""

from __future__ import annotations

UNIT = "ms"


def read(run: dict):
    spans = [s for r in run["clients"] for _, _, a, _, s, _ in
             r["pictures"] if a >= 0.0]
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)

"""fallback_share: the share, in %, of the pictures of the window's
lockstep calls that took the unpacked path alone (a picture that the v2
packer declined) instead of their round's batched step: the lockstep
clients' ``fallbacks`` over those and the pictures of their ``batches``.
None where no client ran a lockstep group."""

from __future__ import annotations

UNIT = "%"


def read(run: dict):
    lock = [r for r in run["clients"] if "fallbacks" in r]
    stepped = sum(sum(r["batches"]) + r["fallbacks"] for r in lock)
    if not stepped:
        return None
    return 100.0 * sum(r["fallbacks"] for r in lock) / stepped

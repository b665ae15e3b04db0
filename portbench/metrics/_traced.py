"""What the per-layer readers share: the pictures of the traced window
and the device time of the kernels whose names hold a pattern."""

from __future__ import annotations

from .. import roofline


def pictures(run: dict) -> list:
    """(client, gop, index) of every picture whose last NAL unit was fed
    inside its client's trace (its step follows it onto the card)."""
    out = []
    for i, r in enumerate(run["clients"]):
        if not r.get("trace"):
            continue
        lo, hi = r["trace"]["t0"] / 1e9, r["trace"]["t1"] / 1e9
        for gop, k, a, b, *_ in r["pictures"]:
            if b is not None and lo <= b + r["t0"] <= hi:
                out.append((i, gop, k))
    return out


def kernel_seconds(run: dict, pattern: str) -> float:
    """Summed device time, over every client, of the operations whose
    names hold `pattern`, inside each client's trace."""
    ns = 0
    for r in run["clients"]:
        for name, (_, t) in (r.get("trace") or {}).get("ops", {}).items():
            if pattern in name:
                ns += t
    return ns / 1e9


def kernel_roofline(run: dict, pattern: str, count) -> float:
    """A kernel's share of its roofline over the clients' traces: the bytes
    `count(classes)` of its pictures, from the manifest, against its
    device time (None where it did not run)."""
    gops = run["manifest"]["gops"]
    nbytes = sum(count(gops[g]["mb_classes"][k])
                 for _, g, k in pictures(run))
    return roofline.share(nbytes, kernel_seconds(run, pattern))

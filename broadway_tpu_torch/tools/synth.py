"""Synthetic operands for the two wavefront kernels (K2 intra, K3
deblock) at any MB geometry, made from a seed with numpy: what the card
tests and ``chip_smoke.py`` feed to a kernel and to its plain version
when no bitstream of that geometry is at hand.

``kind`` is "intra" (every MB has work), "idle" (no MB has work: an
all-inter picture for K2, all bS 0 for K3) or "mixed" (about one MB in
three has work, in runs). The params respect the picture's borders as
the real params do: no neighbour outside the picture is marked
available, and no bS is set on the picture's left or top edge.
"""

from __future__ import annotations

import numpy as np

KINDS = ("intra", "idle", "mixed")


def _busy(rng, kind: str, n: int) -> np.ndarray:
    if kind == "intra":
        return np.ones(n, bool)
    if kind == "idle":
        return np.zeros(n, bool)
    if kind != "mixed":
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
    # runs of idle MBs with busy ones between, and never none at all
    busy = np.convolve(rng.rand(n) < 0.2, np.ones(3), "same")[:n] > 0.5
    busy[rng.randint(n)] = True
    return busy


def planes(w_mbs: int, h_mbs: int, seed: int, smooth: bool = False):
    """Random base planes: Y [16h, 16w] u8, C [2, 8h, 8w] u8. `smooth`
    planes are a gradient plus a few levels of noise, so that the
    deblocking filter's alpha/beta tests pass on most lines (white noise
    fails them nearly everywhere and nothing would be filtered)."""
    rng = np.random.RandomState(seed)
    shapes = ((16 * h_mbs, 16 * w_mbs), (2, 8 * h_mbs, 8 * w_mbs))
    if not smooth:
        return tuple(rng.randint(0, 256, s, dtype=np.uint8) for s in shapes)
    out = []
    for s in shapes:
        ramp = (np.arange(s[-2])[:, None] + 2 * np.arange(s[-1])[None, :]) // 3
        out.append(((ramp + rng.randint(-5, 6, s)) % 256).astype(np.uint8))
    return tuple(out)


def intra_operands(w_mbs: int, h_mbs: int, seed: int, kind: str = "mixed"):
    """(RY [n,16,16] i32, RC [n,2,8,8] i32, P [n,32] i32) for
    ``intra_wavefront``; the lane map is ``ops/gpu/intra.py``'s."""
    rng = np.random.RandomState(seed)
    n = w_mbs * h_mbs
    x = np.arange(n) % w_mbs
    y = np.arange(n) // w_mbs
    intra = _busy(rng, kind, n)
    i4 = intra & (rng.rand(n) < 0.6)
    P = np.zeros((n, 32), np.int32)
    P[:, 0] = (x > 0) & (rng.rand(n) < 0.85)                       # av_a
    P[:, 1] = (y > 0) & (rng.rand(n) < 0.85)                       # av_b
    P[:, 2] = (y > 0) & (x < w_mbs - 1) & (rng.rand(n) < 0.7)      # av_c
    P[:, 3] = (x > 0) & (y > 0) & (rng.rand(n) < 0.85)             # av_d
    P[:, 4] = i4
    P[:, 5] = intra & ~i4
    P[:, 6] = rng.randint(0, 4, n)
    P[:, 7] = rng.randint(0, 4, n)
    P[:, 8] = intra
    P[:, 9:25] = rng.randint(0, 9, (n, 16))
    RY = rng.randint(-300, 301, (n, 16, 16)).astype(np.int32)
    RC = rng.randint(-300, 301, (n, 2, 8, 8)).astype(np.int32)
    return RY, RC, P


def deblock_operands(w_mbs: int, h_mbs: int, seed: int, kind: str = "mixed"):
    """P [n,64] i32 for ``deblock_wavefront``; the lane map is
    ``ops/gpu/deblock.py``'s (bS vertical 0:16, horizontal 16:32, then
    alpha, beta, tc0[1..3] per edge class for luma 32:47 and chroma
    47:62)."""
    rng = np.random.RandomState(seed)
    n = w_mbs * h_mbs
    x = np.arange(n) % w_mbs
    y = np.arange(n) // w_mbs
    busy = _busy(rng, kind, n)
    P = np.zeros((n, 64), np.int32)
    bs = rng.randint(0, 5, (n, 32)) * (rng.rand(n, 32) < 0.7)
    bs[:, 4:16] = np.minimum(bs[:, 4:16], 3)      # inner edges: bS < 4
    bs[:, 20:32] = np.minimum(bs[:, 20:32], 3)
    bs[x == 0, 0:4] = 0
    bs[y == 0, 16:20] = 0
    P[:, :32] = bs * busy[:, None]
    for base in (32, 47):
        for cls in range(3):
            o = base + 5 * cls
            P[:, o] = rng.randint(0, 256, n)               # alpha
            P[:, o + 1] = rng.randint(0, 19, n)            # beta
            P[:, o + 2:o + 5] = np.sort(rng.randint(0, 26, (n, 3)), axis=1)
    return P

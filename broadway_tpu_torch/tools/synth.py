"""Synthetic operands for the kernels at any MB geometry, made from a
seed with numpy: what the tests and ``chip_smoke.py`` feed to a kernel
and to its plain version when no bitstream of that geometry or kind is at
hand. K1 (motion compensation): ``mc_operands`` by case name. K2 (intra)
and K3 (deblock): ``intra_operands`` / ``deblock_operands`` by ``kind``.

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


# ---------------------------------------------------------------------------
# K1: vectors and reference slots by case
# ---------------------------------------------------------------------------

_SIDES = {"lo": -1, "mid": 0, "hi": 1}

MC_CASES = tuple(
    ["mixed_intra_inter", "sixteen_vectors", "random_slots_40",
     "random_slots_300", "random_slots_4000"]
    + [f"frac_{fy}{fx}_{how}" for fy in range(4) for fx in range(4)
       for how in ("one", "blk")]
    + [f"edge_{sy}_{sx}_{reach}" for sy in _SIDES for sx in _SIDES
       for reach in ("near", "far")])


def mc_operands(case: str, w_mbs: int, h_mbs: int, R: int):
    """(mv [n,4,4,2] i32, ref_blk [n,4,4] i32) of one named case:

    mixed_intra_inter  whole MBs with ref_blk -1 among inter MBs with one
                       vector each, as a P picture has them
    sixteen_vectors    every 4x4 block its own vector and slot
    random_slots_S     per-block vectors up to S quarter-pels, per-block
                       slots from -1 (predicts nothing) to R - 1
    frac_YX_one|blk    every vector at quarter-pel fraction (X, Y); one
                       vector for the MB, or another whole part per block
    edge_SY_SX_near|far  every MB thrown at the picture's SY/SX side
                       (lo, mid, hi) so that its window straddles the
                       edge (near) or lies wholly beyond it (far), at a
                       diagonal fraction; odd MBs with one vector, even
                       MBs with their blocks pulled apart by a pel
    """
    n = w_mbs * h_mbs
    rng = np.random.RandomState(
        sum(ord(c) * (i + 1) for i, c in enumerate(case)))
    one = (n, 1, 1)

    def full(a):
        return np.ascontiguousarray(
            np.broadcast_to(a, (n, 4, 4) + a.shape[3:])).astype(np.int32)

    parts = case.split("_")
    if case == "mixed_intra_inter":
        slot = rng.randint(0, R, one)
        slot[rng.rand(n) < 0.4] = -1
        slot[0], slot[-1] = -1, 0          # both kinds, whatever the draw
        return full(rng.randint(-60, 61, one + (2,))), full(slot)
    if case == "sixteen_vectors":
        mv = rng.randint(-50, 51, (n, 4, 4, 2))
        mv[..., 0] += 2 * np.arange(16).reshape(4, 4)   # 16 distinct ones
        return full(mv), full(rng.randint(0, R, (n, 4, 4)))
    if parts[0] == "random":
        span = int(parts[2])
        return (full(rng.randint(-span, span + 1, (n, 4, 4, 2))),
                full(rng.randint(-1, R, (n, 4, 4))))
    if parts[0] == "frac":
        fy, fx = int(parts[1][0]), int(parts[1][1])
        shape = (n, 4, 4, 2) if parts[2] == "blk" else one + (2,)
        mv = rng.randint(-6, 7, shape) * 4 + np.array([fx, fy])
        return full(mv), full(rng.randint(0, R, one))
    if parts[0] == "edge":
        sy, sx = _SIDES[parts[1]], _SIDES[parts[2]]
        off = 40 if parts[3] == "far" else -8
        mb = np.arange(n)
        mbx, mby = mb % w_mbs, mb // w_mbs
        tx = {-1: -16 - off + 0 * mbx, 0: 16 * mbx,
              1: 16 * w_mbs + off + 0 * mbx}[sx]
        ty = {-1: -16 - off + 0 * mby, 0: 16 * mby,
              1: 16 * h_mbs + off + 0 * mby}[sy]
        mv = np.zeros((n, 4, 4, 2), np.int64)
        mv[..., 0] = (4 * (tx - 16 * mbx) + 1)[:, None, None]
        mv[..., 1] = (4 * (ty - 16 * mby) + 3)[:, None, None]
        apart = (mb % 2 == 0)[:, None, None]
        mv[..., 0] += 4 * np.arange(4)[None, None, :] * apart
        mv[..., 1] += 4 * np.arange(4)[None, :, None] * apart
        return full(mv), full(rng.randint(0, R, one))
    raise ValueError(f"unknown MC case {case!r}; one of {MC_CASES}")

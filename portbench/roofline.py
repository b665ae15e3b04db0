"""The work that decoding a picture needs, counted for the kernels'
rooflines, and the card's peak it is read against.

The counts are of the work itself, not of what a kernel happens to do,
so that a later kernel that does the same work is read against the same
count. Each comes from a picture's macroblocks by class (the pool's
manifest: intra, inter, skip), and is in bytes, each input byte read
once and each output byte written once. K1, K2 and K3 are bound by
memory, not by arithmetic (8-bit filters, no matrix product), so a share
of the roofline is the least time that HBM needs for those bytes over
the kernel's summed device time.

A share is stated against the published peak of one NVIDIA H100 SXM
(HBM3, 3.35 TB/s at the 700 W power limit); the run prints the card's
power limit beside it (``device.power_limit_w``).
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12     # NVIDIA H100 SXM data sheet
MB_BYTES = 384                # 16x16 luma + 2 x 8x8 chroma, 8 bits


def k1_mc_bytes(classes: dict) -> int:
    """K1 (motion compensation): per inter macroblock its predicted
    samples written and its reference samples read once."""
    return classes["inter"] * (MB_BYTES + MB_BYTES)


def k2_intra_bytes(classes: dict) -> int:
    """K2 (intra prediction and reconstruction): per intra macroblock its
    samples written and its residual read, 16-bit a sample."""
    return classes["intra"] * (MB_BYTES + 2 * MB_BYTES)


def k3_deblock_bytes(classes: dict) -> int:
    """K3 (in-loop deblocking): per macroblock its samples read and
    written once."""
    n = classes["intra"] + classes["inter"] + classes["skip"]
    return n * (MB_BYTES + MB_BYTES)


def share(nbytes: int, seconds: float):
    """Percent of the roofline: the time HBM needs for `nbytes` over the
    device time `seconds` (None where nothing ran)."""
    if seconds <= 0 or nbytes <= 0:
        return None
    return 100.0 * nbytes / HBM_BYTES_PER_S / seconds

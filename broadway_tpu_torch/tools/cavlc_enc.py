"""CAVLC *encoder* for the test-vector generator (h264enc.py).

Inverse of the decode path in ..bitstream.cavlc; shares the code
tables in ..bitstream.cavlc_tables. Validated block-by-block
against the reference decoder's h264bsdDecodeResidualBlockCavlc
(the reference decoder's h264bsd_cavlc.c:748) via build/oracle/harness.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from ..bitstream.cavlc_tables import (  # noqa: E402
    COEFF_TOKEN,
    RUN_BEFORE,
    TOTAL_ZEROS_4x4,
    TOTAL_ZEROS_CHROMA_DC,
    coeff_token_class,
)

# 4x4 luma block decode order -> (x, y) position in 4x4-block units
# (spec 6.4.3 inverse scan: 8x8 quadrants, z-scan inside).
BLK_ORDER = [(0, 0), (1, 0), (0, 1), (1, 1), (2, 0), (3, 0), (2, 1), (3, 1),
             (0, 2), (1, 2), (0, 3), (1, 3), (2, 2), (3, 2), (2, 3), (3, 3)]
# (x, y) -> decode-order index
BLK_INDEX = {xy: i for i, xy in enumerate(BLK_ORDER)}


def encode_residual_block(w, coeffs: Sequence[int], nc: int,
                          max_coeffs: int) -> int:
    """Append one residual_block_cavlc() to BitWriter `w`.

    `coeffs` is the coefficient-level array in (zig-zag) scan order, length
    <= max_coeffs. Returns total_coeff (for nC context tracking).
    """
    coeffs = list(coeffs) + [0] * (max_coeffs - len(coeffs))
    assert len(coeffs) == max_coeffs
    positions = [i for i, c in enumerate(coeffs) if c != 0]
    total_coeff = len(positions)
    assert total_coeff <= max_coeffs

    if total_coeff == 0:
        ln, bits = COEFF_TOKEN[coeff_token_class(nc)][(0, 0)]
        w.u(ln, bits)
        return 0

    total_zeros = positions[-1] + 1 - total_coeff

    # trailing ones: up to 3 consecutive +/-1 at the end of scan order
    trailing = 0
    while (trailing < 3 and trailing < total_coeff and
           abs(coeffs[positions[-1 - trailing]]) == 1):
        trailing += 1

    ln, bits = COEFF_TOKEN[coeff_token_class(nc)][(trailing, total_coeff)]
    w.u(ln, bits)

    # trailing one sign flags, highest scan position first
    for k in range(trailing):
        w.u(1, 1 if coeffs[positions[-1 - k]] < 0 else 0)

    # remaining levels, highest scan position first
    suffix_length = 1 if (total_coeff > 10 and trailing < 3) else 0
    rem = [coeffs[p] for p in reversed(positions[: total_coeff - trailing])]
    for i, level in enumerate(rem):
        if level > 0:
            level_code = 2 * (level - 1)
        else:
            level_code = -2 * level - 1
        if i == 0 and trailing < 3:
            level_code -= 2
        assert level_code >= 0, (coeffs, "level too small for context")
        if suffix_length == 0:
            if level_code < 14:
                w.u(level_code + 1, 1)          # unary: level_code zeros + 1
            elif level_code < 14 + 16:
                w.u(15, 1)                      # prefix 14
                w.u(4, level_code - 14)
            else:
                assert level_code - 30 < (1 << 12), "level out of range"
                w.u(16, 1)                      # prefix 15 escape
                w.u(12, level_code - 30)
        else:
            if level_code < (15 << suffix_length):
                prefix = level_code >> suffix_length
                w.u(prefix + 1, 1)
                w.u(suffix_length, level_code & ((1 << suffix_length) - 1))
            else:
                esc = level_code - (15 << suffix_length)
                assert esc < (1 << 12), "level out of range"
                w.u(16, 1)
                w.u(12, esc)
        if suffix_length == 0:
            suffix_length = 1
        if abs(level) > (3 << (suffix_length - 1)) and suffix_length < 6:
            suffix_length += 1

    # total_zeros
    if total_coeff < max_coeffs:
        if max_coeffs == 4:
            ln, bits = TOTAL_ZEROS_CHROMA_DC[total_coeff][total_zeros]
        else:
            ln, bits = TOTAL_ZEROS_4x4[total_coeff][total_zeros]
        w.u(ln, bits)

    # run_before, highest scan position first, last run implicit
    zeros_left = total_zeros
    for k in range(total_coeff - 1):
        if zeros_left == 0:
            break
        run = positions[-1 - k] - positions[-2 - k] - 1
        ln, bits = RUN_BEFORE[min(zeros_left, 7)][run]
        w.u(ln, bits)
        zeros_left -= run
    return total_coeff


class CavlcContext:
    """Tracks per-4x4-block totalCoeff across a slice for nC derivation
    (spec 9.2.1). Availability = inside picture and same slice."""

    def __init__(self, width_mbs: int, height_mbs: int) -> None:
        self.w = width_mbs
        self.h = height_mbs
        n = width_mbs * height_mbs
        # -1 = not (yet) decoded / unavailable
        self.luma = [[-1] * 16 for _ in range(n)]
        self.chroma = [[-1] * 8 for _ in range(n)]   # 4 cb then 4 cr
        self.slice_id = [-1] * n

    def start_mb(self, addr: int, slice_id: int = 0) -> None:
        self.slice_id[addr] = slice_id

    def mark_skip(self, addr: int) -> None:
        self.slice_id[addr] = 0 if self.slice_id[addr] < 0 else self.slice_id[addr]
        self.luma[addr] = [0] * 16
        self.chroma[addr] = [0] * 8

    def mark_ipcm(self, addr: int) -> None:
        self.luma[addr] = [16] * 16
        self.chroma[addr] = [16] * 8

    def mark_no_residual(self, addr: int) -> None:
        self.luma[addr] = [0] * 16
        self.chroma[addr] = [0] * 8

    # -- neighbour lookups ---------------------------------------------------

    def _mb_available(self, addr: int, cur_addr: int) -> bool:
        if addr < 0:
            return False
        # decoded before current MB in this slice (raster order assumed)
        return self.luma[addr][0] >= 0 or self.chroma[addr][0] >= 0

    def _luma_nc_at(self, addr: int, bx: int, by: int, cur_addr: int):
        """totalCoeff of luma 4x4 block at block coords (bx, by) of MB
        `addr` or None if unavailable."""
        if bx < 0:
            mbx = addr % self.w
            if mbx == 0:
                return None
            addr, bx = addr - 1, bx + 4
        if by < 0:
            if addr < self.w:
                return None
            addr, by = addr - self.w, by + 4
        if not self._mb_available(addr, cur_addr):
            return None
        v = self.luma[addr][BLK_INDEX[(bx, by)]]
        return None if v < 0 else v

    def luma_nc(self, addr: int, blk: int) -> int:
        bx, by = BLK_ORDER[blk]
        na = self._luma_nc_at(addr, bx - 1, by, addr)
        nb = self._luma_nc_at(addr, bx, by - 1, addr)
        if na is not None and nb is not None:
            return (na + nb + 1) >> 1
        if na is not None:
            return na
        if nb is not None:
            return nb
        return 0

    def _chroma_nc_at(self, addr: int, comp: int, bx: int, by: int):
        if bx < 0:
            if addr % self.w == 0:
                return None
            addr, bx = addr - 1, bx + 2
        if by < 0:
            if addr < self.w:
                return None
            addr, by = addr - self.w, by + 2
        if not self._mb_available(addr, addr):
            return None
        v = self.chroma[addr][comp * 4 + by * 2 + bx]
        return None if v < 0 else v

    def chroma_nc(self, addr: int, comp: int, blk: int) -> int:
        bx, by = blk % 2, blk // 2
        na = self._chroma_nc_at(addr, comp, bx - 1, by)
        nb = self._chroma_nc_at(addr, comp, bx, by - 1)
        if na is not None and nb is not None:
            return (na + nb + 1) >> 1
        if na is not None:
            return na
        if nb is not None:
            return nb
        return 0

    def set_luma(self, addr: int, blk: int, tc: int) -> None:
        self.luma[addr][blk] = tc

    def set_chroma(self, addr: int, comp: int, blk: int, tc: int) -> None:
        self.chroma[addr][comp * 4 + blk] = tc


class ResidualData:
    """Per-MB residual coefficients in scan order.

    luma_dc: 16 coeffs (Intra16x16 only).
    luma:    dict blk(0..15 decode order) -> list of coeffs
             (len 15 for Intra16x16 AC, else 16).
    chroma_dc: dict comp(0,1) -> 4 coeffs.
    chroma_ac: dict (comp, blk 0..3) -> 15 coeffs.
    """

    def __init__(self, luma_dc=None, luma=None, chroma_dc=None,
                 chroma_ac=None) -> None:
        self.luma_dc = luma_dc
        self.luma = luma or {}
        self.chroma_dc = chroma_dc or {}
        self.chroma_ac = chroma_ac or {}


def write_residual_mb(w, ctx: CavlcContext, addr: int, kind: str, cbp: int,
                      residual: ResidualData) -> None:
    """Write residual() syntax for one MB. `cbp` is the full coded block
    pattern (luma bits 0..3 per 8x8, chroma in bits 4..5). For kind=="i16"
    the luma DC block is always coded."""
    is_i16 = kind == "i16"
    if is_i16:
        nc = ctx.luma_nc(addr, 0)
        encode_residual_block(w, residual.luma_dc or [], nc, 16)

    max_c = 15 if is_i16 else 16
    for blk8 in range(4):
        for sub in range(4):
            blk = blk8 * 4 + sub
            if cbp & (1 << blk8):
                nc = ctx.luma_nc(addr, blk)
                coeffs = residual.luma.get(blk, [])
                tc = encode_residual_block(w, coeffs, nc, max_c)
                ctx.set_luma(addr, blk, tc)
            else:
                ctx.set_luma(addr, blk, 0)

    cbp_chroma = cbp >> 4
    if cbp_chroma:
        for comp in range(2):
            coeffs = residual.chroma_dc.get(comp, [])
            encode_residual_block(w, coeffs, -1, 4)
    for comp in range(2):
        for blk in range(4):
            if cbp_chroma == 2:
                nc = ctx.chroma_nc(addr, comp, blk)
                coeffs = residual.chroma_ac.get((comp, blk), [])
                tc = encode_residual_block(w, coeffs, nc, 15)
                ctx.set_chroma(addr, comp, blk, tc)
            else:
                ctx.set_chroma(addr, comp, blk, 0)

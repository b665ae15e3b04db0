"""CAVLC residual block decoding (reference: h264bsd_cavlc.c:748
h264bsdDecodeResidualBlockCavlc).

Table-driven decode using the shared tables in cavlc_tables (validated
entry-by-entry against the reference — tests/test_cavlc_tables.py). Emits
scan-order coefficient arrays; inverse zig-zag + dequant happen in the
device kernels (ops/transform.py), keeping this host stage minimal.
"""

from __future__ import annotations

from typing import List, Tuple

from .bitreader import BitReader, StreamError
from .cavlc_tables import (COEFF_TOKEN, RUN_BEFORE, TOTAL_ZEROS_4x4,
                           TOTAL_ZEROS_CHROMA_DC, coeff_token_class)

# Build prefix-decode LUTs: for each table, map first-16-bits -> (key, len).
# A dict keyed by (length, bits) walked by increasing length is fast enough
# for the host front-end and keeps one table source.


def _build_walker(table):
    by_len = {}
    if isinstance(table, dict):
        items = table.items()
    else:
        items = enumerate(table)
    for key, (ln, bits) in items:
        by_len.setdefault(ln, {})[bits] = key
    return sorted((ln, codes) for ln, codes in by_len.items())


_CT_WALKERS = [_build_walker(t) for t in COEFF_TOKEN]
_TZ_WALKERS = {tc: _build_walker(row) for tc, row in TOTAL_ZEROS_4x4.items()}
_TZC_WALKERS = {tc: _build_walker(row)
                for tc, row in TOTAL_ZEROS_CHROMA_DC.items()}
_RB_WALKERS = {zl: _build_walker(row) for zl, row in RUN_BEFORE.items()}


def _decode_vlc(r: BitReader, walker):
    bits32 = r.peek(32)
    for ln, codes in walker:
        v = codes.get(bits32 >> (32 - ln))
        if v is not None:
            r.skip(ln)
            return v
    raise StreamError("invalid VLC code")


def decode_residual_block(r: BitReader, nc: int,
                          max_coeffs: int) -> List[int]:
    """Decode one residual_block_cavlc; returns scan-order coefficient list
    of length max_coeffs."""
    coeffs = [0] * max_coeffs
    to_tc = _decode_vlc(r, _CT_WALKERS[coeff_token_class(nc)])
    trailing, total_coeff = to_tc
    if total_coeff == 0:
        return coeffs
    if total_coeff > max_coeffs:
        raise StreamError("total_coeff > maxNumCoeff")

    levels = []
    for _ in range(trailing):
        levels.append(-1 if r.flag() else 1)

    suffix_length = 1 if (total_coeff > 10 and trailing < 3) else 0
    for i in range(total_coeff - trailing):
        # level_prefix: zeros then a 1
        prefix = 0
        while not r.flag():
            prefix += 1
            if prefix > 15:
                raise StreamError("level_prefix too long")
        if suffix_length == 0:
            if prefix < 14:
                level_code = prefix
            elif prefix == 14:
                level_code = 14 + r.u(4)
            else:
                level_code = 30 + r.u(12)
        else:
            if prefix < 15:
                level_code = (prefix << suffix_length) + r.u(suffix_length)
            else:
                level_code = (15 << suffix_length) + r.u(12)
        if i == 0 and trailing < 3:
            level_code += 2
        if level_code & 1:
            level = -((level_code + 1) >> 1)
        else:
            level = (level_code + 2) >> 1
        levels.append(level)
        if suffix_length == 0:
            suffix_length = 1
        if abs(level) > (3 << (suffix_length - 1)) and suffix_length < 6:
            suffix_length += 1

    if total_coeff < max_coeffs:
        if max_coeffs == 4:
            total_zeros = _decode_vlc(r, _TZC_WALKERS[total_coeff])
        else:
            total_zeros = _decode_vlc(r, _TZ_WALKERS[total_coeff])
    else:
        total_zeros = 0

    zeros_left = total_zeros
    runs = []
    for i in range(total_coeff - 1):
        if zeros_left > 0:
            run = _decode_vlc(r, _RB_WALKERS[min(zeros_left, 7)])
            if run > zeros_left:
                raise StreamError("run_before > zerosLeft")
        else:
            run = 0
        runs.append(run)
        zeros_left -= run

    pos = zeros_left
    coeffs[pos] = levels[total_coeff - 1]
    for i in range(total_coeff - 2, -1, -1):
        pos += runs[i] + 1
        if pos >= max_coeffs:
            raise StreamError("coefficient position out of range")
        coeffs[pos] = levels[i]
    return coeffs

"""CAVLC code tables (ITU-T H.264 spec tables 9-5, 9-7, 9-8, 9-9, 9-10).

One shared source of truth for both the decoder front-end
(bitstream/cavlc.py) and the test-vector encoder
(tools/cavlc_enc.py of this package). Every entry is validated exhaustively against the
reference decoder's `h264bsdDecodeResidualBlockCavlc`
(the reference decoder's h264bsd_cavlc.c:748) through the
tools/oracle_harness.c CLI — see tests/test_cavlc_tables.py.

Tables are written (length, value) with codes read MSB-first.
"""

# --- Table 9-5: coeff_token --------------------------------------------------
# COEFF_TOKEN[class][(trailing_ones, total_coeff)] = (length, bits)
# class 0: 0 <= nC < 2 ; class 1: 2 <= nC < 4 ; class 2: 4 <= nC < 8
# class 3: nC >= 8 (6-bit FLC) ; class 4: nC == -1 (chroma DC, 4:2:0)

COEFF_TOKEN = [dict() for _ in range(5)]

_T0 = """
0 0 1 1
0 1 6 5    1 1 2 1
0 2 8 7    1 2 6 4    2 2 3 1
0 3 9 7    1 3 8 6    2 3 7 5    3 3 5 3
0 4 10 7   1 4 9 6    2 4 8 5    3 4 6 3
0 5 11 7   1 5 10 6   2 5 9 5    3 5 7 4
0 6 13 15  1 6 11 6   2 6 10 5   3 6 8 4
0 7 13 11  1 7 13 14  2 7 11 5   3 7 9 4
0 8 13 8   1 8 13 10  2 8 13 13  3 8 10 4
0 9 14 15  1 9 14 14  2 9 13 9   3 9 11 4
0 10 14 11 1 10 14 10 2 10 14 13 3 10 13 12
0 11 15 15 1 11 15 14 2 11 14 9  3 11 14 12
0 12 15 11 1 12 15 10 2 12 15 13 3 12 14 8
0 13 16 15 1 13 15 1  2 13 15 9  3 13 15 12
0 14 16 11 1 14 16 14 2 14 16 13 3 14 15 8
0 15 16 7  1 15 16 10 2 15 16 9  3 15 16 12
0 16 16 4  1 16 16 6  2 16 16 5  3 16 16 8
"""

_T1 = """
0 0 2 3
0 1 6 11   1 1 2 2
0 2 6 7    1 2 5 7    2 2 3 3
0 3 7 7    1 3 6 10   2 3 6 9    3 3 4 5
0 4 8 7    1 4 6 6    2 4 6 5    3 4 4 4
0 5 8 4    1 5 7 6    2 5 7 5    3 5 5 6
0 6 9 7    1 6 8 6    2 6 8 5    3 6 6 8
0 7 11 15  1 7 9 6    2 7 9 5    3 7 6 4
0 8 11 11  1 8 11 14  2 8 11 13  3 8 7 4
0 9 12 15  1 9 11 10  2 9 11 9   3 9 9 4
0 10 12 11 1 10 12 14 2 10 12 13 3 10 11 12
0 11 12 8  1 11 12 10 2 11 12 9  3 11 11 8
0 12 13 15 1 12 13 14 2 12 13 13 3 12 12 12
0 13 13 11 1 13 13 10 2 13 13 9  3 13 13 12
0 14 13 7  1 14 14 11 2 14 13 6  3 14 13 8
0 15 14 9  1 15 14 8  2 15 14 10 3 15 13 1
0 16 14 7  1 16 14 6  2 16 14 5  3 16 14 4
"""

_T2 = """
0 0 4 15
0 1 6 15   1 1 4 14
0 2 6 11   1 2 5 15   2 2 4 13
0 3 6 8    1 3 5 12   2 3 5 14   3 3 4 12
0 4 7 15   1 4 5 10   2 4 5 11   3 4 4 11
0 5 7 11   1 5 5 8    2 5 5 9    3 5 4 10
0 6 7 9    1 6 6 14   2 6 6 13   3 6 4 9
0 7 7 8    1 7 6 10   2 7 6 9    3 7 4 8
0 8 8 15   1 8 7 14   2 8 7 13   3 8 5 13
0 9 8 11   1 9 8 14   2 9 7 10   3 9 6 12
0 10 9 15  1 10 8 10  2 10 8 13  3 10 7 12
0 11 9 11  1 11 9 14  2 11 8 9   3 11 8 12
0 12 9 8   1 12 9 10  2 12 9 13  3 12 8 8
0 13 10 13 1 13 9 7   2 13 9 9   3 13 9 12
0 14 10 9  1 14 10 12 2 14 10 11 3 14 10 10
0 15 10 5  1 15 10 8  2 15 10 7  3 15 10 6
0 16 10 1  1 16 10 4  2 16 10 3  3 16 10 2
"""

_T4 = """
0 0 2 1
0 1 6 7    1 1 1 1
0 2 6 4    1 2 6 6    2 2 3 1
0 3 6 3    1 3 7 3    2 3 7 2    3 3 6 5
0 4 6 2    1 4 8 3    2 4 8 2    3 4 7 0
"""


def _parse(tbl, s):
    vals = [int(x) for x in s.split()]
    for i in range(0, len(vals), 4):
        to, tc, ln, bits = vals[i : i + 4]
        tbl[(to, tc)] = (ln, bits)


_parse(COEFF_TOKEN[0], _T0)
_parse(COEFF_TOKEN[1], _T1)
_parse(COEFF_TOKEN[2], _T2)
_parse(COEFF_TOKEN[4], _T4)
# class 3 (nC >= 8): 6-bit FLC; (0,0) is the special code 000011.
COEFF_TOKEN[3][(0, 0)] = (6, 3)
for tc in range(1, 17):
    for to in range(0, min(tc, 3) + 1):
        COEFF_TOKEN[3][(to, tc)] = (6, 4 * (tc - 1) + to)


def coeff_token_class(nc: int) -> int:
    if nc == -1:
        return 4
    if nc < 2:
        return 0
    if nc < 4:
        return 1
    if nc < 8:
        return 2
    return 3


# --- Tables 9-7 / 9-8: total_zeros for 4x4 blocks ---------------------------
# TOTAL_ZEROS_4x4[total_coeff][total_zeros] = (length, bits),
# total_coeff in 1..15, total_zeros in 0..(16 - total_coeff).

# Recovered by black-box probing of the reference decoder
# (tools/calibrate_tz.py) — not transcribed from its source.
_TZ = {
    1: [(1, 1), (3, 3), (3, 2), (4, 3), (4, 2), (5, 3), (5, 2), (6, 3),
        (6, 2), (7, 3), (7, 2), (8, 3), (8, 2), (9, 3), (9, 2), (9, 1)],
    2: [(3, 7), (3, 6), (3, 5), (3, 4), (3, 3), (4, 5), (4, 4), (4, 3),
        (4, 2), (5, 3), (5, 2), (6, 3), (6, 2), (6, 1), (6, 0)],
    3: [(4, 5), (3, 7), (3, 6), (3, 5), (4, 4), (4, 3), (3, 4), (3, 3),
        (4, 2), (5, 3), (5, 2), (6, 1), (5, 1), (6, 0)],
    4: [(5, 3), (3, 7), (4, 5), (4, 4), (3, 6), (3, 5), (3, 4), (4, 3),
        (3, 3), (4, 2), (5, 2), (5, 1), (5, 0)],
    5: [(4, 5), (4, 4), (4, 3), (3, 7), (3, 6), (3, 5), (3, 4), (3, 3),
        (4, 2), (5, 1), (4, 1), (5, 0)],
    6: [(6, 1), (5, 1), (3, 7), (3, 6), (3, 5), (3, 4), (3, 3), (3, 2),
        (4, 1), (3, 1), (6, 0)],
    7: [(6, 1), (5, 1), (3, 5), (3, 4), (3, 3), (2, 3), (3, 2), (4, 1),
        (3, 1), (6, 0)],
    8: [(6, 1), (4, 1), (5, 1), (3, 3), (2, 3), (2, 2), (3, 2), (3, 1),
        (6, 0)],
    9: [(6, 1), (6, 0), (4, 1), (2, 3), (2, 2), (3, 1), (2, 1), (5, 1)],
    10: [(5, 1), (5, 0), (3, 1), (2, 3), (2, 2), (2, 1), (4, 1)],
    11: [(4, 0), (4, 1), (3, 1), (3, 2), (1, 1), (3, 3)],
    12: [(4, 0), (4, 1), (2, 1), (1, 1), (3, 1)],
    13: [(3, 0), (3, 1), (1, 1), (2, 1)],
    14: [(2, 0), (2, 1), (1, 1)],
    15: [(1, 0), (1, 1)],
}

TOTAL_ZEROS_4x4 = _TZ

# --- Table 9-9(a): total_zeros for chroma DC (2x2, 4:2:0) -------------------
# TOTAL_ZEROS_CHROMA_DC[total_coeff][total_zeros], total_coeff 1..3.
TOTAL_ZEROS_CHROMA_DC = {
    1: [(1, 1), (2, 1), (3, 1), (3, 0)],
    2: [(1, 1), (2, 1), (2, 0)],
    3: [(1, 1), (1, 0)],
}

# --- Table 9-10: run_before --------------------------------------------------
# RUN_BEFORE[min(zeros_left, 7)][run] = (length, bits). zeros_left >= 1.
RUN_BEFORE = {
    1: [(1, 1), (1, 0)],
    2: [(1, 1), (2, 1), (2, 0)],
    3: [(2, 3), (2, 2), (2, 1), (2, 0)],
    4: [(2, 3), (2, 2), (2, 1), (3, 1), (3, 0)],
    5: [(2, 3), (2, 2), (3, 3), (3, 2), (3, 1), (3, 0)],
    6: [(2, 3), (3, 0), (3, 1), (3, 3), (3, 2), (3, 5), (3, 4)],
    7: [(3, 7), (3, 6), (3, 5), (3, 4), (3, 3), (3, 2), (3, 1),
        (4, 1), (5, 1), (6, 1), (7, 1), (8, 1), (9, 1), (10, 1), (11, 1)],
}


# --- Table 9-4: coded_block_pattern mapped Exp-Golomb -----------------------
# cbp value (0..47) -> codeNum, for Intra_4x4 and Inter prediction modes.
CBP_TO_CODENUM_INTRA = [
    3, 29, 30, 17, 31, 18, 37, 8, 32, 38, 19, 9, 20, 10, 11, 2,
    16, 33, 34, 21, 35, 22, 39, 4, 36, 40, 23, 5, 24, 6, 7, 1,
    41, 42, 43, 25, 44, 26, 46, 12, 45, 47, 27, 13, 28, 14, 15, 0,
]
CBP_TO_CODENUM_INTER = [
    0, 2, 3, 7, 4, 8, 17, 13, 5, 18, 9, 14, 10, 15, 16, 11,
    1, 32, 33, 36, 34, 37, 44, 40, 35, 45, 38, 41, 39, 42, 43, 19,
    6, 24, 25, 20, 26, 21, 46, 28, 27, 47, 22, 29, 23, 30, 31, 12,
]

CODENUM_TO_CBP_INTRA = [0] * 48
CODENUM_TO_CBP_INTER = [0] * 48
for _cbp, _cn in enumerate(CBP_TO_CODENUM_INTRA):
    CODENUM_TO_CBP_INTRA[_cn] = _cbp
for _cbp, _cn in enumerate(CBP_TO_CODENUM_INTER):
    CODENUM_TO_CBP_INTER[_cn] = _cbp


def build_prefix_decoder(table):
    """Invert a {(key): (len, bits)} or [(len, bits)] table into a dict
    mapping (len, bits) -> key for MSB-first longest-prefix decode."""
    inv = {}
    if isinstance(table, dict):
        items = table.items()
    else:
        items = enumerate(table)
    for key, (ln, bits) in items:
        assert (ln, bits) not in inv, (key, ln, bits)
        inv[(ln, bits)] = key
    return inv

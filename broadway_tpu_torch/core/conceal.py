"""Error concealment — mirror of h264bsd_conceal.c (h264bsdConceal :125,
ConcealMb :257, simplified Transform :592) and
h264bsd_slice_data.c:302 h264bsdMarkSliceCorrupted.

Missing/corrupt MBs are concealed by DC + first-order interpolation from
the nearest decoded neighbours (I pictures) or by a co-located copy from
the first available reference (P pictures). Whole-picture loss gives
gray 128 (I, default policy) or a reference copy. Concealed MBs get
qpY=40 and intra type so deblocking smooths them; whole-picture conceal
disables the filter.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..bitstream.mb_layer import MB_I4x4, PictureData
from ..bitstream.slice_group_map import next_mb_address
from .recon_cpu import Frame

I_SLICE = 2


def mark_slice_corrupted(pic: PictureData, first_mb: int,
                         sg_map: np.ndarray, slice_id: int,
                         last_mb_addr: int, width_mbs: int) -> None:
    """Un-decode the MBs of a corrupted slice (reference behaviour: for I
    slices keep all but the last max(width,10) same-slice MBs before
    last_mb_addr; inter slices lose everything)."""
    addr = first_mb
    if last_mb_addr:
        i = last_mb_addr - 1
        cnt = 0
        while i > addr:
            if pic.slice_id[i] == slice_id:
                cnt += 1
                if cnt >= max(width_mbs, 10):
                    break
            i -= 1
        addr = i
    while addr >= 0:
        if pic.slice_id[addr] == slice_id and pic.decoded[addr]:
            pic.decoded[addr] = False
        else:
            break
        addr = next_mb_address(sg_map, addr)


def _transform(d: np.ndarray) -> None:
    """Simplified inverse transform on [16] with only d[0], d[1], d[4]."""
    if not d[1] and not d[4]:
        d[1:] = d[0]
        return
    t0, t1 = int(d[0]), int(d[1])
    d[0] = t0 + t1
    d[1] = t0 + (t1 >> 1)
    d[2] = t0 - (t1 >> 1)
    d[3] = t0 - t1
    t0 = int(d[4])
    d[5] = t0
    d[6] = t0
    d[7] = t0
    for c in range(4):
        t0, t1 = int(d[c]), int(d[4 + c])
        d[c] = t0 + t1
        d[4 + c] = t0 + (t1 >> 1)
        d[8 + c] = t0 - (t1 >> 1)
        d[12 + c] = t0 - t1


def _conceal_plane(plane: np.ndarray, row: int, col: int, size: int,
                   decoded_grid: np.ndarray) -> None:
    """DC-interpolate one size x size MB block of `plane` at MB (row,col)."""
    h_mbs, w_mbs = decoded_grid.shape
    y0, x0 = row * size, col * size
    q = size // 4                     # 4 luma / 2 chroma pels per section
    fp = np.zeros(16, np.int64)
    a = b = l = r = None
    hor = ver = 0
    if row > 0 and decoded_grid[row - 1, col]:
        pels = plane[y0 - 1, x0:x0 + size].astype(np.int64)
        a = pels.reshape(4, q).sum(1)
        hor += 1
        fp[0] += a.sum()
        fp[1] += a[0] + a[1] - a[2] - a[3]
    if row < h_mbs - 1 and decoded_grid[row + 1, col]:
        pels = plane[y0 + size, x0:x0 + size].astype(np.int64)
        b = pels.reshape(4, q).sum(1)
        hor += 1
        fp[0] += b.sum()
        fp[1] += b[0] + b[1] - b[2] - b[3]
    if col > 0 and decoded_grid[row, col - 1]:
        pels = plane[y0:y0 + size, x0 - 1].astype(np.int64)
        l = pels.reshape(4, q).sum(1)
        ver += 1
        fp[0] += l.sum()
        fp[4] += l[0] + l[1] - l[2] - l[3]
    if col < w_mbs - 1 and decoded_grid[row, col + 1]:
        pels = plane[y0:y0 + size, x0 + size].astype(np.int64)
        r = pels.reshape(4, q).sum(1)
        ver += 1
        fp[0] += r.sum()
        fp[4] += r[0] + r[1] - r[2] - r[3]
    j = hor + ver

    # luma shifts use one extra bit (16-pel sections vs 8)
    s = 1 if size == 16 else 0
    if not hor and l is not None and r is not None:
        fp[1] = (l.sum() - r.sum()) >> (4 + s)
    elif hor:
        fp[1] >>= (2 + s + hor)
    if not ver and a is not None and b is not None:
        fp[4] = (a.sum() - b.sum()) >> (4 + s)
    elif ver:
        fp[4] >>= (2 + s + ver)
    if j == 1:
        fp[0] >>= 3 + s
    elif j == 2:
        fp[0] >>= 4 + s
    elif j == 3:
        fp[0] = (21 * fp[0]) >> (9 + s)
    else:
        fp[0] >>= 5 + s

    _transform(fp)
    vals = np.clip(fp.reshape(4, 4), 0, 255).astype(np.uint8)
    block = np.repeat(np.repeat(vals, q, axis=0), q, axis=1)
    plane[y0:y0 + size, x0:x0 + size] = block


def conceal_picture(pic: PictureData, frame: Frame, slice_type: int,
                    ref_frame: Optional[Frame],
                    intra_conceal_from_ref: bool = False) -> int:
    """Conceal all undecoded MBs in-place; returns concealed count and
    updates pic metadata (qp=40, intra type, deblock params)."""
    w_mbs, h_mbs = pic.width_mbs, pic.height_mbs
    n = pic.n_mbs
    decoded = pic.decoded.reshape(h_mbs, w_mbs)
    use_ref = (slice_type != I_SLICE or intra_conceal_from_ref) and \
        ref_frame is not None

    n_concealed = int(n - pic.decoded.sum())
    if not hasattr(pic, "concealed"):
        pic.concealed = np.zeros(n, bool)

    # whole picture lost
    if not pic.decoded.any():
        if use_ref:
            frame.y[:] = ref_frame.y
            frame.cb[:] = ref_frame.cb
            frame.cr[:] = ref_frame.cr
        else:
            frame.y[:] = 128
            frame.cb[:] = 128
            frame.cr[:] = 128
        pic.concealed[:] = True
        pic.whole_pic_concealed = True
        pic.decoded[:] = True
        return n

    def conceal_mb(row, col):
        addr = row * w_mbs + col
        pic.qp[addr] = 40
        pic.mb_class[addr] = MB_I4x4
        pic.skip[addr] = False
        pic.total_coeff[addr] = 0
        pic.concealed[addr] = True
        if use_ref:
            y0, x0 = row * 16, col * 16
            frame.y[y0:y0 + 16, x0:x0 + 16] = \
                ref_frame.y[y0:y0 + 16, x0:x0 + 16]
            frame.cb[row * 8:row * 8 + 8, col * 8:col * 8 + 8] = \
                ref_frame.cb[row * 8:row * 8 + 8, col * 8:col * 8 + 8]
            frame.cr[row * 8:row * 8 + 8, col * 8:col * 8 + 8] = \
                ref_frame.cr[row * 8:row * 8 + 8, col * 8:col * 8 + 8]
        else:
            _conceal_plane(frame.y, row, col, 16, decoded)
            _conceal_plane(frame.cb, row, col, 8, decoded)
            _conceal_plane(frame.cr, row, col, 8, decoded)
        decoded[row, col] = True

    # find first decoded MB
    flat = pic.decoded
    first = int(np.argmax(flat))
    row, col = first // w_mbs, first % w_mbs

    for j in range(col - 1, -1, -1):
        conceal_mb(row, j)
    for j in range(col + 1, w_mbs):
        if not decoded[row, j]:
            conceal_mb(row, j)
    if row:
        for j in range(w_mbs):
            for i in range(row - 1, -1, -1):
                conceal_mb(i, j)
    for i in range(row + 1, h_mbs):
        for j in range(w_mbs):
            if not decoded[i, j]:
                conceal_mb(i, j)
    pic.whole_pic_concealed = False
    return n_concealed

"""The compact v2 picture buffer: its layout and host packer, and the
device-side unpack (counterpart of ``broadway_tpu.core.packed``'s v2
half).

The layout (``PackedLayoutV2``), the bucket rules and the host packer
(``pack_picture_v2`` over the native ``bw_pack_picture2``) are this
package's own copy and write the same bytes as the JAX package's. The
unpack runs on the buffer's device and returns the same per-MB dict
(same keys, shapes and values; integer arrays as int32, flags as bool).
The v1 format is not ported.

Layout, 13 B/MB base instead of dense per-block arrays, everything
block-granular sparse:
  - mv/ref: one uniform (mv, ref) per MB + 80-byte exception rows for
    MBs with non-uniform partitions
  - i4 modes: exception rows for I4x4 MBs with any nonzero mode
  - total_coeff: a 16-bit mask (deblock bS only needs tc > 0)
  - per-slice deblock params: a 1024-entry table indexed by slice_id
It must match the native ``bw_pack_picture2`` (csrc/frontend.cpp).

The JAX unpack scatters the sparse rows with ``mode="drop"``: pad rows
carry the out-of-range index NR (NE for exception rows). torch has no
drop mode, and an out-of-range index on CUDA is a device-side assert, so
every scatter here goes into a space one row larger whose last row
collects the pad rows and is then cut off.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..bitstream.mb_layer import MB_I4x4, MB_I16x16, MB_IPCM, MB_P, \
    PictureData

I32 = torch.int32


class PackedLayoutV2:
    """Static buffer layout v2 for a (w_mbs, h_mbs) picture grid.

    Sections: 13 B/MB base | slice-param table | i8 coeff rows
    (idx i32 + 16 x i8 = 20 B) | i16 coeff rows (36 B; large levels +
    I_PCM) | exception rows (84 B). Each sparse section is padded to a
    bucket size (the JAX package's jit signatures; kept so that both
    packages pack the same bytes)."""

    SPT = 3 * 1024        # slice-param table bytes

    def __init__(self, w_mbs: int, h_mbs: int) -> None:
        self.w = w_mbs
        self.h = h_mbs
        n = w_mbs * h_mbs
        self.n = n
        self.base_size = 13 * n + self.SPT
        self.NR = 38 * n                      # coeff sparse row space
        self.NE = n                           # exception row space
        # all sparse-section offsets are 1024-aligned: the native packer
        # and the JAX package's buffers share this layout byte for byte
        self.idx_off = (self.base_size + 1023) & ~1023

        def ladder(steps):
            out = [b for b in steps if b < self.NR]
            return out + [self.NR]

        self.k8buckets = ladder((4096, 8192, 16384, 32768, 65536,
                                 262144))
        self.k16buckets = ladder((512, 4096, 65536))
        eb = [b for b in (512, 1024, 2048, 4096, 8192) if b < self.NE]
        self.ebuckets = eb + [self.NE]

    @staticmethod
    def _pick(buckets, k):
        for b in buckets:
            if b >= k:
                return b
        return buckets[-1]

    def bucket8(self, k: int) -> int:
        return self._pick(self.k8buckets, k)

    def bucket16(self, k: int) -> int:
        return self._pick(self.k16buckets, k)

    def ebucket(self, e: int) -> int:
        return self._pick(self.ebuckets, e)

    # section offsets for bucket sizes (kb8, kb16, eb)
    def val8_off(self, kb8: int) -> int:
        return (self.idx_off + 4 * kb8 + 1023) & ~1023

    def idx16_off(self, kb8: int) -> int:
        return (self.val8_off(kb8) + 16 * kb8 + 1023) & ~1023

    def val16_off(self, kb8: int, kb16: int) -> int:
        return (self.idx16_off(kb8) + 4 * kb16 + 1023) & ~1023

    def eidx_off(self, kb8: int, kb16: int) -> int:
        return (self.val16_off(kb8, kb16) + 32 * kb16 + 1023) & ~1023

    def eval_off(self, kb8: int, kb16: int, eb: int) -> int:
        return (self.eidx_off(kb8, kb16) + 4 * eb + 1023) & ~1023

    def total_size(self, kb8: int, kb16: int, eb: int) -> int:
        # padded to 1024, as the JAX package's buffers are
        return (self.eval_off(kb8, kb16, eb) + 80 * eb + 1023) & ~1023

    def __hash__(self):
        return hash((self.w, self.h, "v2"))

    def __eq__(self, other):
        return isinstance(other, PackedLayoutV2) and \
            (self.w, self.h) == (other.w, other.h)


_LAYOUTS_V2: Dict[tuple, PackedLayoutV2] = {}


def get_packed_layout_v2(w_mbs: int, h_mbs: int) -> PackedLayoutV2:
    key = (w_mbs, h_mbs)
    if key not in _LAYOUTS_V2:
        _LAYOUTS_V2[key] = PackedLayoutV2(w_mbs, h_mbs)
    return _LAYOUTS_V2[key]


class PackScratchV2:
    """Reusable host-side buffers for the native v2 packer."""

    def __init__(self, lay: PackedLayoutV2) -> None:
        self.lay = lay
        self.base = np.empty(lay.base_size, np.uint8)
        self.idx8 = np.empty(lay.NR, np.int32)
        self.val8 = np.empty((lay.NR, 16), np.int8)
        self.idx = np.empty(lay.NR, np.int32)
        self.val = np.empty((lay.NR, 16), np.int16)
        self.eidx = np.empty(lay.NE, np.int32)
        self.eval_ = np.empty((lay.NE, 80), np.uint8)


def pack_picture_v2(pic: PictureData, lay: PackedLayoutV2,
                    scratch: PackScratchV2, force=None):
    """Native pack + bucket-padded single-buffer assembly.
    Returns (uint8 buffer, (kb8, kb16, eb)), or None if the picture
    does not fit the v2 format (more than 1024 slices). force pins the
    bucket triple."""
    from ..bitstream.native import pack_picture2_native
    if len(pic.slice_params) > 1024:
        return None
    k8, k, e = pack_picture2_native(pic, scratch.base, scratch.idx8,
                                    scratch.val8, scratch.idx,
                                    scratch.val, scratch.eidx,
                                    scratch.eval_)
    if force is not None:
        kb8, kb16, eb = force
        if k8 > kb8 or k > kb16 or e > eb:
            return None
    else:
        kb8, kb16, eb = (lay.bucket8(k8), lay.bucket16(k),
                         lay.ebucket(e))
    buf = np.empty(lay.total_size(kb8, kb16, eb), np.uint8)
    buf[:lay.base_size] = scratch.base

    io = lay.idx_off
    iv = buf[io:io + 4 * kb8].view(np.int32)
    iv[:k8] = scratch.idx8[:k8]
    iv[k8:] = lay.NR         # out of range -> dropped by the scatter
    vo = lay.val8_off(kb8)
    buf[vo:vo + 16 * kb8].view(np.int8).reshape(kb8, 16)[:k8] = \
        scratch.val8[:k8]

    io = lay.idx16_off(kb8)
    iv = buf[io:io + 4 * kb16].view(np.int32)
    iv[:k] = scratch.idx[:k]
    iv[k:] = lay.NR
    vo = lay.val16_off(kb8, kb16)
    buf[vo:vo + 32 * kb16].view(np.int16).reshape(kb16, 16)[:k] = \
        scratch.val[:k]

    eo = lay.eidx_off(kb8, kb16)
    ei = buf[eo:eo + 4 * eb].view(np.int32)
    ei[:e] = scratch.eidx[:e]
    ei[e:] = lay.NE
    evo = lay.eval_off(kb8, kb16, eb)
    buf[evo:evo + 80 * eb].reshape(eb, 80)[:e] = scratch.eval_[:e]
    return buf, (kb8, kb16, eb)


def _shift_grid(g: torch.Tensor, dy: int, dx: int, fill) -> torch.Tensor:
    """grid[y, x] -> grid[y+dy, x+dx] with out-of-bounds -> fill."""
    h, w = g.shape[:2]
    out = torch.full_like(g, fill)
    ys = slice(max(-dy, 0), h + min(-dy, 0))
    xs = slice(max(-dx, 0), w + min(-dx, 0))
    nys = slice(max(dy, 0), h + min(dy, 0))
    nxs = slice(max(dx, 0), w + min(dx, 0))
    out[ys, xs] = g[nys, nxs]
    return out


def _u8_i32x4(x4):      # u8 [m, 4] -> i32 [m]
    x = x4.to(I32)
    return x[:, 0] | (x[:, 1] << 8) | (x[:, 2] << 16) | (x[:, 3] << 24)


def _u8_u16(x):         # u8 [2m] -> i32 [m] (zero-extended)
    x = x.reshape(-1, 2).to(I32)
    return x[:, 0] | (x[:, 1] << 8)


def _u8_i16(x):         # u8 [2m] -> i32 [m] (sign-extended)
    return ((_u8_u16(x) + 32768) & 65535) - 32768


def _u8_i8(x):          # u8 [m] -> i32 [m] (sign-extended)
    return ((x.to(I32) + 128) & 255) - 128


def _i16_bytes(v):      # i16-valued i32 [..., m] -> u8-valued [..., m, 2]
    return torch.stack([v & 255, (v >> 8) & 255], dim=-1)


def _scatter_rows(n_rows: int, idx: torch.Tensor, vals: torch.Tensor,
                  out: torch.Tensor = None) -> torch.Tensor:
    """out[idx[k]] = vals[k] for 0 <= idx[k] < n_rows; other rows dropped.
    Returns the [n_rows, ...] result (allocated zero if out is None)."""
    if out is None:
        out = torch.zeros((n_rows + 1,) + vals.shape[1:], dtype=vals.dtype,
                          device=vals.device)
    keep = (idx >= 0) & (idx < n_rows)
    out[torch.where(keep, idx, n_rows).long()] = vals
    return out


def pack_stream(data: bytes, max_pics: int = None):
    """Parse an Annex-B stream with the host engine and pack each
    picture (v2) as the Decoder does, reconstructing no pixels.
    Returns [(buf, bk, layout, constrained_intra, chroma_qp_offset,
    n_slots)], n_slots = dpb_size + 1 as the Decoder's stacks."""
    from . import decoder as DEC

    out = []

    def collect(dec, pic):
        if max_pics is None or len(out) < max_pics:
            lay = get_packed_layout_v2(dec.sps.width_mbs,
                                       dec.sps.height_mbs)
            res = pack_picture_v2(pic, lay, PackScratchV2(lay))
            if res is None:
                raise ValueError("picture does not fit the v2 format")
            out.append((res[0], res[1], lay, dec.pps.constrained_intra_pred,
                        dec.pps.chroma_qp_index_offset,
                        dec.dpb.dpb_size + 1))
        return DEC.SKIP_RECON

    dec = DEC.Decoder(device="cpu", recon_strategy=collect)
    try:
        dec.decode_annexb(data)
    finally:
        dec.close()
    return out


def unpack_arrs_v2(buf: torch.Tensor, lay: PackedLayoutV2, bk: tuple,
                   constrained_intra: bool, chroma_qp_offset: int
                   ) -> Dict[str, torch.Tensor]:
    """buf u8 [size] (v2 layout, on any device) -> the per-MB dict that
    ``core.recon.decode_picture`` consumes. bk = (kb8, kb16, eb)."""
    if buf.dtype != torch.uint8 or buf.dim() != 1:
        raise ValueError(f"v2 buffer must be 1-D uint8, got {buf.dtype} "
                         f"{tuple(buf.shape)}")
    n, w, h = lay.n, lay.w, lay.h
    kb8, kb16, eb = bk
    if buf.numel() < lay.total_size(kb8, kb16, eb):
        raise ValueError("v2 buffer shorter than its bucket layout")
    dev = buf.device

    def seg(off, ln):
        return buf[off:off + ln]

    cls = seg(0, n).to(I32)
    qp = seg(n, n).to(I32)
    cbp = seg(2 * n, n).to(I32)
    modes = seg(3 * n, n).to(I32)
    i16_mode = modes & 3
    chroma_mode = (modes >> 2) & 3
    sid = _u8_u16(seg(4 * n, 2 * n))
    tcm = _u8_u16(seg(6 * n, 2 * n))
    mv_mb = _u8_i16(seg(8 * n, 4 * n)).reshape(n, 2)
    ref_mb = _u8_i8(seg(12 * n, n))
    spt = _u8_i8(seg(13 * n, lay.SPT)).reshape(1024, 3)

    # total_coeff from the bitmask (bS only tests > 0)
    bit = torch.arange(16, dtype=I32, device=dev)[None, :]
    total_coeff = ((tcm[:, None] >> bit) & 1).reshape(n, 4, 4)

    # per-slice deblock params via table lookup
    sidc = sid.clamp(0, 1023).long()
    idc = spt[:, 0][sidc]
    offA = spt[:, 1][sidc]
    offB = spt[:, 2][sidc]

    # two-tier coefficient scatter into one dense row space
    idx8 = _u8_i32x4(seg(lay.idx_off, 4 * kb8).reshape(kb8, 4))
    vals8 = _u8_i8(seg(lay.val8_off(kb8), 16 * kb8)).reshape(kb8, 16)
    idx16 = _u8_i32x4(seg(lay.idx16_off(kb8), 4 * kb16).reshape(kb16, 4))
    vals16 = _u8_i16(seg(lay.val16_off(kb8, kb16),
                         32 * kb16)).reshape(kb16, 16)
    dense = _scatter_rows(lay.NR, idx8, vals8)
    dense = _scatter_rows(lay.NR, idx16, vals16, out=dense)[:lay.NR]
    luma_coeffs = dense[:16 * n].reshape(n, 4, 4, 16)
    chroma_ac = dense[16 * n:24 * n].reshape(n, 2, 2, 2, 16)
    luma_dc = dense[24 * n:25 * n].reshape(n, 16)
    chroma_dc = dense[25 * n:26 * n, :8].reshape(n, 2, 4)
    ipcm = _i16_bytes(dense[26 * n:38 * n].reshape(n, 192)).reshape(n, 384)

    # exception scatter: mv/ref grids or i4 modes
    eidx = _u8_i32x4(seg(lay.eidx_off(kb8, kb16), 4 * eb).reshape(eb, 4))
    evals = seg(lay.eval_off(kb8, kb16, eb), 80 * eb).reshape(eb, 80)
    edense = _scatter_rows(lay.NE, eidx, evals)[:lay.NE]
    has_exc = _scatter_rows(
        lay.NE, eidx, torch.ones(eb, dtype=torch.bool, device=dev))[:lay.NE]
    exc_mv = _u8_i16(edense[:, :64].reshape(-1)).reshape(n, 4, 4, 2)
    exc_ref = _u8_i8(edense[:, 64:80]).reshape(n, 4, 4)
    exc_i4 = edense[:, 0:16].to(I32).reshape(n, 4, 4)

    is_i4 = cls == MB_I4x4
    mv_exc = has_exc & ~is_i4
    mv = torch.where(mv_exc[:, None, None, None], exc_mv,
                     mv_mb[:, None, None, :].expand(n, 4, 4, 2))
    ref_blk = torch.where(mv_exc[:, None, None], exc_ref,
                          ref_mb[:, None, None].expand(n, 4, 4))
    i4_modes = torch.where((has_exc & is_i4)[:, None, None], exc_i4, 0)

    # --- derived flags (every MB decoded on this path) ----------------
    clsg = cls.reshape(h, w)
    sidg = sid.reshape(h, w)
    idcg = idc.reshape(h, w)
    ones = torch.ones((h, w), dtype=torch.bool, device=dev)

    def nb_ok(dy, dx):
        in_b = _shift_grid(ones, dy, dx, False)
        ok = in_b & (_shift_grid(sidg, dy, dx, -1) == sidg)
        if constrained_intra:
            ok = ok & (_shift_grid(clsg, dy, dx, MB_P) != MB_P)
        return ok.reshape(n)

    enable = idc != 1

    def db_nb(dy, dx):
        in_b = _shift_grid(ones, dy, dx, False)
        same = _shift_grid(sidg, dy, dx, -1) == sidg
        return (in_b & ((idcg != 2) | same)).reshape(n)

    return {
        "mb_class": cls,
        "qp": qp,
        "cbp": cbp,
        "is_i16": cls == MB_I16x16,
        "i16_mode": i16_mode,
        "chroma_mode": chroma_mode,
        "i4_modes": i4_modes.contiguous(),
        "luma_coeffs": luma_coeffs,
        "luma_dc": luma_dc,
        "chroma_dc": chroma_dc,
        "chroma_ac": chroma_ac,
        "total_coeff": total_coeff,
        "mv": mv.contiguous(),
        "ref_blk": ref_blk.contiguous(),
        "ipcm": ipcm,
        "av_a": nb_ok(0, -1), "av_b": nb_ok(-1, 0),
        "av_c": nb_ok(-1, 1), "av_d": nb_ok(-1, -1),
        "offA": offA, "offB": offB,
        "chroma_off_mb": torch.full((n,), chroma_qp_offset, dtype=I32,
                                    device=dev),
        "FT": enable & db_nb(-1, 0), "FL": enable & db_nb(0, -1),
        "enable": enable,
        "is_inter": cls == MB_P,
        "is_pcm": cls == MB_IPCM,
        # host scalar: never concealed on this path, read without a sync
        "whole_conceal": torch.tensor(False),
    }

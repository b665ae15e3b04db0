"""The packed picture buffers: their layouts and host packers, and the
device-side unpacks (counterpart of ``broadway_tpu.core.packed``).

The layouts (``PackedLayoutV2``, ``PackedLayout``), the bucket rules and
the host packers (``pack_picture_v2`` over the native
``bw_pack_picture2``, ``pack_picture`` over ``bw_pack_picture``) are this
package's own copy and write the same bytes as the JAX package's. The
unpacks run on the buffer's device and return the same per-MB dict
(same keys, shapes and values; integer arrays as int32, flags as bool).

v1 (``PackedLayout``, 122 B/MB of dense per-block arrays + sparse i16
coefficient rows) is what a picture takes when v2 declines it (more than
1024 slices), or when the caller asks for it. ``unpack_arrs_v2`` also
takes a batch of buffers ``[B, size]`` that share one bucket triple
(``expand_buf_v2``), for the lockstep decode of several streams.

The v2 layout, 13 B/MB base instead of dense per-block arrays, everything
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


def expand_buf_v2(buf: np.ndarray, lay: PackedLayoutV2, bk: tuple,
                  BK: tuple) -> np.ndarray:
    """Re-bucket a packed v2 buffer to larger (kb8, kb16, eb) sections
    (pad rows carry the out-of-range index and are dropped by the device
    scatter). The lockstep decode brings the buffers of one round to one
    bucket triple with it, so that they unpack as one batch."""
    if BK == bk:
        return buf
    kb8, kb16, eb = bk
    K8, K16, EB = BK
    if K8 < kb8 or K16 < kb16 or EB < eb:
        raise ValueError(f"cannot shrink buckets {bk} to {BK}")
    out = np.zeros(lay.total_size(K8, K16, EB), np.uint8)
    out[:lay.base_size] = buf[:lay.base_size]

    def grow(src_idx, src_val, n_src, dst_idx, dst_val, n_dst, row_bytes,
             pad):
        """one sparse section: its indices (padded with `pad`), its rows"""
        oi = out[dst_idx:dst_idx + 4 * n_dst].view(np.int32)
        oi[:n_src] = buf[src_idx:src_idx + 4 * n_src].view(np.int32)
        oi[n_src:] = pad
        out[dst_val:dst_val + row_bytes * n_src] = \
            buf[src_val:src_val + row_bytes * n_src]

    grow(lay.idx_off, lay.val8_off(kb8), kb8,
         lay.idx_off, lay.val8_off(K8), K8, 16, lay.NR)
    grow(lay.idx16_off(kb8), lay.val16_off(kb8, kb16), kb16,
         lay.idx16_off(K8), lay.val16_off(K8, K16), K16, 32, lay.NR)
    grow(lay.eidx_off(kb8, kb16), lay.eval_off(kb8, kb16, eb), eb,
         lay.eidx_off(K8, K16), lay.eval_off(K8, K16, EB), EB, 80, lay.NE)
    return out


def _shift_grid(g: torch.Tensor, dy: int, dx: int, fill) -> torch.Tensor:
    """grid[..., y, x] -> grid[..., y+dy, x+dx] with out-of-bounds ->
    fill; leading axes (a batch of pictures) are left alone."""
    h, w = g.shape[-2:]
    out = torch.full_like(g, fill)
    ys = slice(max(-dy, 0), h + min(-dy, 0))
    xs = slice(max(-dx, 0), w + min(-dx, 0))
    nys = slice(max(dy, 0), h + min(dy, 0))
    nxs = slice(max(dx, 0), w + min(dx, 0))
    out[..., ys, xs] = g[..., nys, nxs]
    return out


# little-endian byte decoders over the last axis
def _u8_i32(x):         # u8 [..., 4m] -> i32 [..., m]
    x = x.reshape(*x.shape[:-1], -1, 4).to(I32)
    return x[..., 0] | (x[..., 1] << 8) | (x[..., 2] << 16) | (x[..., 3] << 24)


def _u8_u16(x):         # u8 [..., 2m] -> i32 [..., m] (zero-extended)
    x = x.reshape(*x.shape[:-1], -1, 2).to(I32)
    return x[..., 0] | (x[..., 1] << 8)


def _u8_i16(x):         # u8 [..., 2m] -> i32 [..., m] (sign-extended)
    return ((_u8_u16(x) + 32768) & 65535) - 32768


def _u8_i8(x):          # u8 [..., m] -> i32 [..., m] (sign-extended)
    return ((x.to(I32) + 128) & 255) - 128


def _i16_bytes(v):      # i16-valued i32 [..., m] -> u8-valued [..., m, 2]
    return torch.stack([v & 255, (v >> 8) & 255], dim=-1)


def _scatter_rows(n_rows: int, idx: torch.Tensor, vals: torch.Tensor,
                  out: torch.Tensor = None) -> torch.Tensor:
    """out[b * n_rows + idx[b, k]] = vals[b, k] for 0 <= idx[b, k] <
    n_rows; other rows are dropped. idx [B, K], vals [B, K, ...]. Returns
    the [B * n_rows + 1, ...] space (allocated zero if out is None): each
    picture of the batch has its own n_rows rows, so that no index lands
    in another picture's, and the dropped rows of all of them share the
    one spare row at the end, which the caller cuts off."""
    B = idx.shape[0]
    if out is None:
        out = torch.zeros((B * n_rows + 1,) + vals.shape[2:],
                          dtype=vals.dtype, device=vals.device)
    keep = (idx >= 0) & (idx < n_rows)
    if B > 1:
        idx = idx + torch.arange(0, B * n_rows, n_rows, device=idx.device,
                                 dtype=idx.dtype)[:, None]
    out[torch.where(keep, idx, B * n_rows).long().reshape(-1)] = \
        vals.reshape((-1,) + vals.shape[2:])
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


def _derived_flags(cls, sid, idc, h: int, w: int, constrained_intra: bool):
    """Intra availability and deblock gates from per-MB class, slice id
    and disable_deblocking_idc ([B, n] each), every MB decoded: av_a..av_d,
    FT, FL, enable as flat [B * n] bools. The MB grids keep the picture
    axis, so a neighbour is never taken from another picture."""
    B = cls.shape[0]
    clsg = cls.reshape(B, h, w)
    sidg = sid.reshape(B, h, w)
    idcg = idc.reshape(B, h, w)
    ones = torch.ones((h, w), dtype=torch.bool, device=cls.device)

    def nb_ok(dy, dx):
        in_b = _shift_grid(ones, dy, dx, False)
        ok = in_b & (_shift_grid(sidg, dy, dx, -1) == sidg)
        if constrained_intra:
            ok = ok & (_shift_grid(clsg, dy, dx, MB_P) != MB_P)
        return ok.reshape(-1)

    enable = (idc != 1).reshape(-1)

    def db_nb(dy, dx):
        in_b = _shift_grid(ones, dy, dx, False)
        same = _shift_grid(sidg, dy, dx, -1) == sidg
        return (in_b & ((idcg != 2) | same)).reshape(-1)

    return {"av_a": nb_ok(0, -1), "av_b": nb_ok(-1, 0),
            "av_c": nb_ok(-1, 1), "av_d": nb_ok(-1, -1),
            "FT": enable & db_nb(-1, 0), "FL": enable & db_nb(0, -1),
            "enable": enable}


def _coeff_sections(dense: torch.Tensor, B: int, n: int):
    """The dense coefficient row space [B, 38n, 16] -> the dict's
    luma_coeffs, chroma_ac, luma_dc, chroma_dc, ipcm (B*n rows each)."""
    N = B * n
    return {
        "luma_coeffs": dense[:, :16 * n].reshape(N, 4, 4, 16),
        "chroma_ac": dense[:, 16 * n:24 * n].reshape(N, 2, 2, 2, 16),
        "luma_dc": dense[:, 24 * n:25 * n].reshape(N, 16),
        "chroma_dc": dense[:, 25 * n:26 * n, :8].reshape(N, 2, 4),
        "ipcm": _i16_bytes(dense[:, 26 * n:38 * n].reshape(N, 192))
        .reshape(N, 384),
    }


def _batched(buf: torch.Tensor, size: int, what: str):
    """A packed buffer [size] or a batch [B, size] as (buf [B, size],
    whole_conceal): no picture is concealed on a packed path, and the
    flag stays on the host (a scalar for one picture, [B] for a batch),
    where reading it costs no device sync."""
    if buf.dtype != torch.uint8 or buf.dim() not in (1, 2):
        raise ValueError(f"{what} buffer must be uint8 [size] or [B, size], "
                         f"got {buf.dtype} {tuple(buf.shape)}")
    if buf.shape[-1] < size:
        raise ValueError(f"{what} buffer shorter than its bucket layout")
    if buf.dim() == 1:
        return buf[None], torch.tensor(False)
    if buf.shape[0] < 1:
        raise ValueError(f"{what} batch is empty")
    return buf, torch.zeros(buf.shape[0], dtype=torch.bool)


def unpack_arrs_v2(buf: torch.Tensor, lay: PackedLayoutV2, bk: tuple,
                   constrained_intra: bool, chroma_qp_offset: int
                   ) -> Dict[str, torch.Tensor]:
    """buf u8 [size] (v2 layout, on any device) -> the per-MB dict that
    ``core.recon.decode_picture`` consumes. bk = (kb8, kb16, eb).

    buf [B, size]: B pictures of one geometry and one bucket triple
    (``expand_buf_v2``), unpacked together: every section sits at the same
    offset in every row, so each op below works on all of them at once.
    The dict then has the pictures one after the other on the MB axis
    ([B*n, ...]) and ``whole_conceal`` [B]."""
    n, w, h = lay.n, lay.w, lay.h
    kb8, kb16, eb = bk
    buf, whole_conceal = _batched(buf, lay.total_size(kb8, kb16, eb), "v2")
    B = buf.shape[0]
    N = B * n
    dev = buf.device

    def seg(off, ln):
        return buf[:, off:off + ln]

    cls = seg(0, n).to(I32)
    qp = seg(n, n).to(I32)
    cbp = seg(2 * n, n).to(I32)
    modes = seg(3 * n, n).to(I32)
    sid = _u8_u16(seg(4 * n, 2 * n))
    tcm = _u8_u16(seg(6 * n, 2 * n))
    mv_mb = _u8_i16(seg(8 * n, 4 * n)).reshape(N, 2)
    ref_mb = _u8_i8(seg(12 * n, n)).reshape(N)
    spt = _u8_i8(seg(13 * n, lay.SPT)).reshape(B, 1024, 3)

    # total_coeff from the bitmask (bS only tests > 0)
    bit = torch.arange(16, dtype=I32, device=dev)
    total_coeff = ((tcm.reshape(N, 1) >> bit) & 1).reshape(N, 4, 4)

    # per-slice deblock params via table lookup, each picture in its own
    sidc = sid.clamp(0, 1023).long()
    idc = spt[:, :, 0].gather(1, sidc)
    offA = spt[:, :, 1].gather(1, sidc)
    offB = spt[:, :, 2].gather(1, sidc)

    # two-tier coefficient scatter into one dense row space
    idx8 = _u8_i32(seg(lay.idx_off, 4 * kb8))
    vals8 = _u8_i8(seg(lay.val8_off(kb8), 16 * kb8)).reshape(B, kb8, 16)
    idx16 = _u8_i32(seg(lay.idx16_off(kb8), 4 * kb16))
    vals16 = _u8_i16(seg(lay.val16_off(kb8, kb16),
                         32 * kb16)).reshape(B, kb16, 16)
    dense = _scatter_rows(lay.NR, idx8, vals8)
    dense = _scatter_rows(lay.NR, idx16, vals16, out=dense)[:B * lay.NR] \
        .reshape(B, lay.NR, 16)

    # exception scatter: mv/ref grids or i4 modes
    eidx = _u8_i32(seg(lay.eidx_off(kb8, kb16), 4 * eb))
    evals = seg(lay.eval_off(kb8, kb16, eb), 80 * eb).reshape(B, eb, 80)
    edense = _scatter_rows(lay.NE, eidx, evals)[:N]
    has_exc = _scatter_rows(
        lay.NE, eidx, torch.ones((B, eb), dtype=torch.bool, device=dev))[:N]
    exc_mv = _u8_i16(edense[:, :64]).reshape(N, 4, 4, 2)
    exc_ref = _u8_i8(edense[:, 64:80]).reshape(N, 4, 4)
    exc_i4 = edense[:, 0:16].to(I32).reshape(N, 4, 4)

    flat = cls.reshape(N)
    is_i4 = flat == MB_I4x4
    mv_exc = has_exc & ~is_i4
    mv = torch.where(mv_exc[:, None, None, None], exc_mv,
                     mv_mb[:, None, None, :].expand(N, 4, 4, 2))
    ref_blk = torch.where(mv_exc[:, None, None], exc_ref,
                          ref_mb[:, None, None].expand(N, 4, 4))
    i4_modes = torch.where((has_exc & is_i4)[:, None, None], exc_i4, 0)

    modes = modes.reshape(N)
    out = {
        "mb_class": flat,
        "qp": qp.reshape(N),
        "cbp": cbp.reshape(N),
        "is_i16": flat == MB_I16x16,
        "i16_mode": modes & 3,
        "chroma_mode": (modes >> 2) & 3,
        "i4_modes": i4_modes.contiguous(),
        "total_coeff": total_coeff,
        "mv": mv.contiguous(),
        "ref_blk": ref_blk.contiguous(),
        "offA": offA.reshape(N), "offB": offB.reshape(N),
        "chroma_off_mb": torch.full((N,), chroma_qp_offset, dtype=I32,
                                    device=dev),
        "is_inter": flat == MB_P,
        "is_pcm": flat == MB_IPCM,
        "whole_conceal": whole_conceal,
    }
    out.update(_coeff_sections(dense, B, n))
    # derived flags (every MB decoded on this path)
    out.update(_derived_flags(cls, sid, idc, h, w, constrained_intra))
    return out


# ---------------------------------------------------------------------------
# v1: dense per-block base sections + sparse i16 coefficient rows. Taken
# when v2 declines a picture, or on request (Decoder(pack="v1")).
# ---------------------------------------------------------------------------

class PackedLayout:
    """Static buffer layout v1 for a (w_mbs, h_mbs) picture grid: 122
    B/MB base | sparse coefficient rows (idx i32 + 16 x i16), padded to a
    bucket size. It must match the native ``bw_pack_picture``
    (csrc/frontend.cpp)."""

    def __init__(self, w_mbs: int, h_mbs: int) -> None:
        self.w = w_mbs
        self.h = h_mbs
        n = w_mbs * h_mbs
        self.n = n
        self.base_size = 122 * n
        self.NR = 38 * n                      # sparse row space
        # 1024-aligned section offsets, as the JAX package's buffers
        self.idx_off = (self.base_size + 1023) & ~1023
        buckets = []
        b = 4096
        while b < self.NR:
            buckets.append(b)
            b *= 4
        buckets.append(self.NR)
        self.buckets = buckets

    def bucket(self, k: int) -> int:
        for b in self.buckets:
            if b >= k:
                return b
        return self.NR

    def val_off(self, kb: int) -> int:
        return (self.idx_off + 4 * kb + 1023) & ~1023

    def total_size(self, kb: int) -> int:
        return (self.val_off(kb) + 32 * kb + 1023) & ~1023

    def __hash__(self):
        return hash((self.w, self.h))

    def __eq__(self, other):
        return isinstance(other, PackedLayout) and \
            (self.w, self.h) == (other.w, other.h)


_LAYOUTS: Dict[tuple, PackedLayout] = {}


def get_packed_layout(w_mbs: int, h_mbs: int) -> PackedLayout:
    key = (w_mbs, h_mbs)
    if key not in _LAYOUTS:
        _LAYOUTS[key] = PackedLayout(w_mbs, h_mbs)
    return _LAYOUTS[key]


class PackScratch:
    """Reusable host-side buffers for the native v1 packer."""

    def __init__(self, lay: PackedLayout) -> None:
        self.lay = lay
        self.base = np.empty(lay.base_size, np.uint8)
        self.idx = np.empty(lay.NR, np.int32)
        self.val = np.empty((lay.NR, 16), np.int16)


def pack_picture(pic: PictureData, lay: PackedLayout, scratch: PackScratch):
    """Native v1 pack + bucket-padded single-buffer assembly.
    Returns (uint8 buffer, bucket size kb)."""
    from ..bitstream.native import pack_picture_native
    k = pack_picture_native(pic, scratch.base, scratch.idx, scratch.val)
    kb = lay.bucket(k)
    buf = np.empty(lay.total_size(kb), np.uint8)
    buf[:lay.base_size] = scratch.base
    io = lay.idx_off
    iv = buf[io:io + 4 * kb].view(np.int32)
    iv[:k] = scratch.idx[:k]
    iv[k:] = lay.NR          # out of range -> dropped by the scatter
    vo = lay.val_off(kb)
    vv = buf[vo:vo + 32 * kb].view(np.int16).reshape(kb, 16)
    vv[:k] = scratch.val[:k]
    return buf, kb


def unpack_arrs(buf: torch.Tensor, lay: PackedLayout, kb: int,
                constrained_intra: bool, chroma_qp_offset: int
                ) -> Dict[str, torch.Tensor]:
    """buf u8 [size] (v1 layout, on any device) -> the per-MB dict that
    ``core.recon.decode_picture`` consumes; a batch [B, size] of one
    bucket size as ``unpack_arrs_v2`` takes it."""
    n, w, h = lay.n, lay.w, lay.h
    buf, whole_conceal = _batched(buf, lay.total_size(kb), "v1")
    B = buf.shape[0]
    N = B * n
    dev = buf.device

    def seg(off, ln):
        return buf[:, off:off + ln]

    cls = seg(0, n).to(I32)
    idc = seg(5 * n, n).to(I32)
    sid = _u8_u16(seg(8 * n, 2 * n))
    idx = _u8_i32(seg(lay.idx_off, 4 * kb))
    vals = _u8_i16(seg(lay.val_off(kb), 32 * kb)).reshape(B, kb, 16)
    dense = _scatter_rows(lay.NR, idx, vals)[:B * lay.NR] \
        .reshape(B, lay.NR, 16)
    flat = cls.reshape(N)
    out = {
        "mb_class": flat,
        "qp": seg(n, n).to(I32).reshape(N),
        "cbp": seg(2 * n, n).to(I32).reshape(N),
        "is_i16": flat == MB_I16x16,
        "i16_mode": seg(3 * n, n).to(I32).reshape(N),
        "chroma_mode": seg(4 * n, n).to(I32).reshape(N),
        "i4_modes": seg(10 * n, 16 * n).to(I32).reshape(N, 4, 4),
        "total_coeff": seg(26 * n, 16 * n).to(I32).reshape(N, 4, 4),
        "mv": _u8_i16(seg(58 * n, 64 * n)).reshape(N, 4, 4, 2),
        "ref_blk": _u8_i8(seg(42 * n, 16 * n)).reshape(N, 4, 4),
        "offA": _u8_i8(seg(6 * n, n)).reshape(N),
        "offB": _u8_i8(seg(7 * n, n)).reshape(N),
        "chroma_off_mb": torch.full((N,), chroma_qp_offset, dtype=I32,
                                    device=dev),
        "is_inter": flat == MB_P,
        "is_pcm": flat == MB_IPCM,
        "whole_conceal": whole_conceal,
    }
    out.update(_coeff_sections(dense, B, n))
    out.update(_derived_flags(cls, sid, idc, h, w, constrained_intra))
    return out


# ---------------------------------------------------------------------------
# the unpacked arrays as one buffer (the static input of an unpacked graph)
# ---------------------------------------------------------------------------

_ALIGN = 256        # every array starts where a CUDA allocation would


def host_arrays_layout(arrs: Dict[str, np.ndarray]) -> tuple:
    """Where each per-MB array of ``core.recon.host_picture_arrays`` (or
    of the stacked band arrays of ``parallel.slices``) lies in one byte
    buffer: a tuple of (name, is_bool, shape, offset), then the buffer's
    size last. ``whole_conceal`` is not in it: the steps read that flag
    on the host. Arrays keep ``state.tables_from_numpy``'s types (bool
    stays bool, every integer type becomes int32). The shapes are the
    picture's geometry's, so the layout (which a graph's key holds) is
    one per geometry and form."""
    fields, off = [], 0
    for name in sorted(arrs):
        if name == "whole_conceal":
            continue
        v = arrs[name]
        is_bool = v.dtype == np.bool_
        fields.append((name, is_bool, tuple(v.shape), off))
        off += -(-v.size * (1 if is_bool else 4) // _ALIGN) * _ALIGN
    return tuple(fields) + (off,)


def pack_host_arrays(arrs: Dict[str, np.ndarray], layout: tuple
                     ) -> np.ndarray:
    """The arrays of `layout` (``host_arrays_layout``) as one u8 buffer."""
    buf = np.zeros(layout[-1], np.uint8)
    for name, is_bool, shape, off in layout[:-1]:
        v = np.asarray(arrs[name], np.bool_ if is_bool else np.int32)
        if v.shape != shape:
            raise ValueError(f"{name}: {v.shape}, the layout holds {shape}")
        buf[off:off + v.nbytes] = v.reshape(-1).view(np.uint8)
    return buf


def view_host_arrays(buf: torch.Tensor, layout: tuple
                     ) -> Dict[str, torch.Tensor]:
    """The per-MB dict (without ``whole_conceal``) as views of buf u8
    [size] (``pack_host_arrays``'s, on any device): no copy, so a graph's
    static buffer is each array's static input."""
    if buf.dtype != torch.uint8 or buf.dim() != 1 or \
            buf.shape[0] != layout[-1]:
        raise ValueError(f"buf must be u8 [{layout[-1]}], got {buf.dtype} "
                         f"{tuple(buf.shape)}")
    out = {}
    for name, is_bool, shape, off in layout[:-1]:
        n = int(np.prod(shape, dtype=np.int64))
        if is_bool:
            v = buf[off:off + n].view(torch.bool)
        else:
            v = buf[off:off + 4 * n].view(torch.int32)
        out[name] = v.view(shape)
    return out

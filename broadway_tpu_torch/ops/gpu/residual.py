"""Residual stage: dequant + inverse transforms as int32 torch ops.

Twin of ``broadway_tpu.ops.tpu.residual`` (bit-exact int32 semantics of
h264bsd_transform.c) plus stage 1 of the JAX pipeline
(``recon_tpu.decode_picture_impl``): it runs data-parallel over every
block of the picture. The JAX package left this to XLA outside Pallas,
so it is plain tensor code here too, not a kernel.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from .tables import tables

I32 = torch.int32


def _idct_rows_cols(d: torch.Tensor) -> torch.Tensor:
    """[..., 4, 4] dequantized -> [..., 4, 4] residual (4x4 integer IDCT)."""
    t0 = d[..., :, 0] + d[..., :, 2]
    t1 = d[..., :, 0] - d[..., :, 2]
    t2 = (d[..., :, 1] >> 1) - d[..., :, 3]
    t3 = d[..., :, 1] + (d[..., :, 3] >> 1)
    h = torch.stack([t0 + t3, t1 + t2, t1 - t2, t0 - t3], dim=-1)
    t0 = h[..., 0, :] + h[..., 2, :]
    t1 = h[..., 0, :] - h[..., 2, :]
    t2 = (h[..., 1, :] >> 1) - h[..., 3, :]
    t3 = h[..., 1, :] + (h[..., 3, :] >> 1)
    return torch.stack([(t0 + t3 + 32) >> 6, (t1 + t2 + 32) >> 6,
                        (t1 - t2 + 32) >> 6, (t0 - t3 + 32) >> 6], dim=-2)


def dequant_idct(coeffs: torch.Tensor, qp: torch.Tensor,
                 dc: torch.Tensor = None) -> torch.Tensor:
    """coeffs [..., 16] int32 scan order; qp broadcastable to
    coeffs[..., 0]; dc optional [...] replaces position 0 after dequant.
    -> [..., 4, 4] int32."""
    t = tables(coeffs.device)
    scale = t["LEVEL_SCALE"][(qp % 6).long()][..., t["POS_CLASS"].long()] \
        << (qp // 6)[..., None]
    d = coeffs[..., t["INV_ZZ"].long()] * scale
    if dc is not None:
        d = torch.cat([dc[..., None].to(I32), d[..., 1:]], dim=-1)
    return _idct_rows_cols(d.reshape(*d.shape[:-1], 4, 4))


def _hadamard4(d: torch.Tensor) -> torch.Tensor:
    t0 = d[..., :, 0] + d[..., :, 2]
    t1 = d[..., :, 0] - d[..., :, 2]
    t2 = d[..., :, 1] - d[..., :, 3]
    t3 = d[..., :, 1] + d[..., :, 3]
    h = torch.stack([t0 + t3, t1 + t2, t1 - t2, t0 - t3], dim=-1)
    t0 = h[..., 0, :] + h[..., 2, :]
    t1 = h[..., 0, :] - h[..., 2, :]
    t2 = h[..., 1, :] - h[..., 3, :]
    t3 = h[..., 1, :] + h[..., 3, :]
    return torch.stack([t0 + t3, t1 + t2, t1 - t2, t0 - t3], dim=-2)


def luma_dc_transform(dc_scan: torch.Tensor, qp: torch.Tensor
                      ) -> torch.Tensor:
    """[..., 16] scan order -> [..., 4, 4] per-block DC (raster)."""
    t = tables(dc_scan.device)
    raster = dc_scan[..., t["INV_ZZ"].long()]
    v = _hadamard4(raster.reshape(*raster.shape[:-1], 4, 4))
    qp_div = qp // 6
    lev = t["LEVEL_SCALE"][(qp % 6).long(), 0]
    hi = v * (lev << (qp_div - 2).clamp(min=0))[..., None, None]
    rnd = torch.where(qp_div == 1, 1, 2).to(I32)[..., None, None]
    shift = (2 - qp_div).clamp(min=0)[..., None, None]
    lo = (v * lev[..., None, None] + rnd) >> shift
    return torch.where((qp >= 12)[..., None, None], hi, lo)


def chroma_dc_transform(dcv: torch.Tensor, qp: torch.Tensor
                        ) -> torch.Tensor:
    """[..., 4] -> [..., 4] transformed chroma DC; qp is the chroma QP."""
    t = tables(dcv.device)
    a, b, c, d = dcv[..., 0], dcv[..., 1], dcv[..., 2], dcv[..., 3]
    t0, t1 = a + c, a - c
    t2, t3 = b - d, b + d
    v = torch.stack([t0 + t3, t0 - t3, t1 + t2, t1 - t2], dim=-1)
    qp_div = qp // 6
    lev = t["LEVEL_SCALE"][(qp % 6).long(), 0]
    hi = v * (lev << (qp_div - 1).clamp(min=0))[..., None]
    lo = (v * lev[..., None]) >> 1
    return torch.where((qp >= 6)[..., None], hi, lo)


def residual_stage(arrs: Dict[str, torch.Tensor], chroma_qp_offset: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stage 1 of the pipeline over raster MB space.

    Returns res_y [N, 16, 16] and res_c [N, 2, 8, 8] (cb, cr) int32."""
    t = tables(arrs["qp"].device)
    qp = arrs["qp"]
    cbp = arrs["cbp"]
    is_i16 = arrs["is_i16"]
    N = qp.shape[0]
    dc = luma_dc_transform(arrs["luma_dc"], qp)                  # [N,4,4]
    coeffs = arrs["luma_coeffs"]                                 # [N,4,4,16]
    # one IDCT pass: for I16x16 MBs position 0 is the Hadamard DC, for
    # the others the value dequant gives anyway (coeff[0] * scale[0])
    scale0 = t["LEVEL_SCALE"][(qp % 6).long(), t["POS_CLASS"][0].long()] \
        << (qp // 6)
    dc0 = coeffs[..., 0] * scale0[:, None, None]
    dc_m = torch.where(is_i16[:, None, None], dc, dc0)
    res_m = dequant_idct(coeffs, qp[:, None, None], dc=dc_m)    # [N,4,4,4,4]
    blk8 = (torch.arange(4, device=qp.device) // 2)
    blk8 = (blk8[:, None] * 2 + blk8[None, :]).to(I32)
    has = ((cbp[:, None, None] >> blk8[None]) & 1) != 0
    res = torch.where((is_i16[:, None, None] | has)[..., None, None],
                      res_m, 0)
    res_y = res.permute(0, 1, 3, 2, 4).reshape(N, 16, 16)

    qpc = t["QP_C"][(qp + chroma_qp_offset).clamp(0, 51).long()]
    cdc = chroma_dc_transform(arrs["chroma_dc"], qpc[:, None])   # [N,2,4]
    cbp_c = cbp >> 4
    cdc = torch.where((cbp_c > 0)[:, None, None, None],
                      cdc.reshape(N, 2, 2, 2), 0)
    # chroma AC rows exist only when cbp_c == 2 (parser invariant), so
    # the DC-only variant equals this one with zero AC: one pass
    cres = dequant_idct(arrs["chroma_ac"], qpc[:, None, None, None],
                        dc=cdc)                          # [N,2,2,2,4,4]
    cres = torch.where((cbp_c > 0)[:, None, None, None, None, None],
                       cres, 0)
    res_c = cres.permute(0, 1, 2, 4, 3, 5).reshape(N, 2, 8, 8)
    return res_y.to(I32).contiguous(), res_c.to(I32).contiguous()

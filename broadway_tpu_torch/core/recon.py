"""Whole-picture reconstruction on the device (torch twin of
``broadway_tpu.core.recon_tpu``'s ``decode_picture_impl`` with
``wf="pallas"``, ``update_stack_slot`` and ``decode_picture_packed2``).

Dataflow per picture:
  1. residual dequant + IDCT over raster MB space (ops/gpu/residual.py)
  2. motion compensation, K1 (ops/gpu/mc_kernel.py)
  3. base assembly: inter (pred + res) and I_PCM pixels into raster
     uint8 planes, 0 at intra MBs
  4. intra wavefront, K2, in place (ops/gpu/wavefront_kernels.py)
  5. deblock parameters, then the deblock wavefront, K3, in place
The planes stay raster throughout: no diagonal-major packing.

The reference-plane stacks are unpadded uint8 (core/state.py); the
picture's planes are written into its DPB slot after decode.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..ops.gpu import mc_kernel as K1
from ..ops.gpu import wavefront_kernels as KW
from ..ops.gpu.deblock import deblock_params
from ..ops.gpu.intra import intra_params
from ..ops.gpu.residual import residual_stage
from .packed import PackedLayoutV2, unpack_arrs_v2

U8 = torch.uint8


class TorchFrame:
    """A decoded picture. The device copy is one uint8 YUV buffer
    (``yuv``) with plane views ``dev_y``, ``dev_cb``, ``dev_cr``; the
    host planes ``y``, ``cb``, ``cr`` (numpy uint8, what the shared host
    code reads) are fetched on first access, all three in one copy."""

    __slots__ = ("yuv", "dev_y", "dev_cb", "dev_cr", "_host")

    def __init__(self, yuv: torch.Tensor, width: int, height: int) -> None:
        n_y = width * height
        n_c = n_y // 4
        self.yuv = yuv
        self.dev_y = yuv[:n_y].view(height, width)
        self.dev_cb = yuv[n_y:n_y + n_c].view(height // 2, width // 2)
        self.dev_cr = yuv[n_y + n_c:].view(height // 2, width // 2)
        self._host = None

    @classmethod
    def from_planes(cls, y, cb, cr, device) -> "TorchFrame":
        """Frame from three host planes (numpy, values 0..255)."""
        yuv = np.concatenate([np.asarray(p, np.uint8).reshape(-1)
                              for p in (y, cb, cr)])
        h, w = np.shape(y)
        return cls(torch.from_numpy(yuv).to(device), w, h)

    def _fetch(self):
        if self._host is None:
            buf = self.yuv.cpu().numpy()
            h, w = self.dev_y.shape
            n_y, n_c = h * w, h * w // 4
            self._host = (buf, buf[:n_y].reshape(h, w),
                          buf[n_y:n_y + n_c].reshape(h // 2, w // 2),
                          buf[n_y + n_c:].reshape(h // 2, w // 2))
        return self._host

    @property
    def y(self) -> np.ndarray:
        return self._fetch()[1]

    @property
    def cb(self) -> np.ndarray:
        return self._fetch()[2]

    @property
    def cr(self) -> np.ndarray:
        return self._fetch()[3]

    def tobytes(self) -> bytes:
        return self._fetch()[0].tobytes()


def decode_picture(arrs: Dict[str, torch.Tensor], ref_y: torch.Tensor,
                   ref_c: torch.Tensor, w_mbs: int, h_mbs: int,
                   chroma_qp_offset: int, run_stages: int = 3
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reconstruct one picture -> (Y [H, W] u8, C [2, H/2, W/2] u8).

    arrs: the per-MB dict (core/packed.py unpack_arrs_v2, or
    ``recon_tpu.host_picture_arrays`` through ``state.tables_from_numpy``)
    on the stacks' device. run_stages as in the JAX pipeline: 0 base
    assembly without MC, 1 with MC, 2 + intra, 3 + deblock."""
    N = w_mbs * h_mbs
    dev = ref_y.device
    res_y, res_c = residual_stage(arrs, chroma_qp_offset)

    if run_stages == 0:
        pred_y = torch.zeros((N, 16, 16), dtype=torch.int32, device=dev)
        pred_c = torch.zeros((N, 8, 16), dtype=torch.int32, device=dev)
    else:
        pred_y, pred_c = K1.mc_predict(ref_y, ref_c,
                                       arrs["mv"].contiguous(),
                                       arrs["ref_blk"].contiguous(),
                                       w_mbs, h_mbs)
    # [n, 8, 16] interleaved lanes -> [n, 2, 8, 8]
    pred_c = pred_c.view(N, 8, 8, 2).permute(0, 3, 1, 2)

    pcm = arrs["ipcm"].to(torch.int32)
    is_p = arrs["is_inter"][:, None, None]
    is_pcm = arrs["is_pcm"][:, None, None]
    base_y = torch.where(is_pcm, pcm[:, :256].reshape(N, 16, 16),
                         torch.where(is_p, (pred_y + res_y).clamp(0, 255),
                                     0))
    base_c = torch.where(is_pcm[:, None],
                         pcm[:, 256:384].reshape(N, 2, 8, 8),
                         torch.where(is_p[:, None],
                                     (pred_c + res_c).clamp(0, 255), 0))
    Y = base_y.to(U8).view(h_mbs, w_mbs, 16, 16).permute(0, 2, 1, 3) \
        .reshape(16 * h_mbs, 16 * w_mbs).contiguous()
    C = base_c.to(U8).view(h_mbs, w_mbs, 2, 8, 8).permute(2, 0, 3, 1, 4) \
        .reshape(2, 8 * h_mbs, 8 * w_mbs).contiguous()
    if run_stages <= 1:
        return Y, C

    KW.intra_wavefront(Y, C, res_y, res_c, intra_params(arrs), w_mbs, h_mbs)
    if run_stages <= 2:
        return Y, C

    # a wholly concealed picture is not deblocked (the JAX cond); the
    # packed path keeps this flag on the host, so reading it costs no sync
    if bool(arrs["whole_conceal"]):
        return Y, C
    KW.deblock_wavefront(Y, C, deblock_params(arrs, w_mbs, h_mbs),
                         w_mbs, h_mbs)
    return Y, C


def update_stack_slot(ref_y: torch.Tensor, ref_c: torch.Tensor, slot: int,
                      frame: TorchFrame) -> None:
    """Write one decoded frame into the reference stacks at its DPB
    frame-store slot (in place)."""
    ref_y[slot].copy_(frame.dev_y)
    ref_c[slot, 0].copy_(frame.dev_cb)
    ref_c[slot, 1].copy_(frame.dev_cr)


def decode_picture_packed2(buf: torch.Tensor, ref_y: torch.Tensor,
                           ref_c: torch.Tensor, slot: int,
                           lay: PackedLayoutV2, bk: tuple,
                           constrained_intra: bool, chroma_qp_offset: int
                           ) -> TorchFrame:
    """The per-picture step: one uploaded v2 buffer in, the picture's
    frame out, and its planes written into stack slot `slot`."""
    arrs = unpack_arrs_v2(buf, lay, bk, constrained_intra, chroma_qp_offset)
    Y, C = decode_picture(arrs, ref_y, ref_c, lay.w, lay.h,
                          chroma_qp_offset)
    frame = TorchFrame(torch.cat([Y.reshape(-1), C.reshape(-1)]),
                       16 * lay.w, 16 * lay.h)
    update_stack_slot(ref_y, ref_c, slot, frame)
    return frame

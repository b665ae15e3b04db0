"""YUV420 -> RGB conversion on the device of the planes — the port of
``broadway_tpu/player/yuv2rgb.py``, the analogue of the reference's two
converters:

- `yuv420_to_rgba_int`: bit-exact mirror of the hand-written asm.js
  converter (Player/Decoder.js:427-638 asmFactory / yuv2rgbcalc):
  r = (1192(y-16) + 1634(v-128)) >> 10, etc., clipped, RGBA output.
- `yuv_to_rgb_rec601` / `yuv_to_rgb_rec709`: float path matching the
  WebGL fragment shader (Player/YUVCanvas.js:247-339) with the
  rec601/rec709 matrices.

The JAX package computes these as fused ``jnp`` expressions outside any
Pallas kernel, so plain torch ops are their port. They run on the device
of their inputs and take a ``TorchFrame``'s ``dev_y``, ``dev_cb``,
``dev_cr`` as they are, without a trip through the host. The float path
is written as explicit float32 multiply-adds in a fixed order (no
``einsum``/``matmul``), so no library precision setting (TF32) enters.
"""

from __future__ import annotations

import numpy as np
import torch

REC601 = np.array([
    [1.16438, 0.00000, 1.59603, -0.87079],
    [1.16438, -0.39176, -0.81297, 0.52959],
    [1.16438, 2.01723, 0.00000, -1.08139],
], np.float32)

REC709 = np.array([
    [1.16438, 0.00000, 1.79274, -0.97295],
    [1.16438, -0.21325, -0.53291, 0.30148],
    [1.16438, 2.11240, 0.00000, -1.13340],
], np.float32)


def _upsample_chroma(c: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample (matches both reference paths)."""
    return c.repeat_interleave(2, dim=0).repeat_interleave(2, dim=1)


def yuv420_to_rgba_int(y: torch.Tensor, cb: torch.Tensor,
                       cr: torch.Tensor) -> torch.Tensor:
    """[H,W]+[H/2,W/2]x2 uint8/int32 -> [H,W,4] uint8 RGBA (asm.js math)."""
    yv = y.to(torch.int32)
    # the chroma terms at chroma resolution, upsampled afterwards
    u = cb.to(torch.int32) - 128
    v = cr.to(torch.int32) - 128
    a0 = 1192 * (yv - 16)
    r = ((a0 + _upsample_chroma(1634 * v)) >> 10).clamp(0, 255)
    g = ((a0 - _upsample_chroma(832 * v + 400 * u)) >> 10).clamp(0, 255)
    b = ((a0 + _upsample_chroma(2066 * u)) >> 10).clamp(0, 255)
    return torch.stack([r, g, b, torch.full_like(r, 255)],
                       dim=-1).to(torch.uint8)


def yuv_to_rgb_rec601(y, cb, cr):
    return _matrix_convert(y, cb, cr, REC601)


def yuv_to_rgb_rec709(y, cb, cr):
    return _matrix_convert(y, cb, cr, REC709)


def _matrix_convert(y, cb, cr, m: np.ndarray) -> torch.Tensor:
    """[H,W,3] uint8: per channel ((y*m0 + u*m1) + v*m2) + m3 in float32,
    in that order, on planes scaled to 0..1; then * 255 + 0.5, clipped,
    truncated."""
    yf = y.to(torch.float32) / 255.0
    uf = _upsample_chroma(cb.to(torch.float32) / 255.0)
    vf = _upsample_chroma(cr.to(torch.float32) / 255.0)
    rows = []
    for m0, m1, m2, m3 in m.tolist():
        rows.append(((yf * m0 + uf * m1) + vf * m2) + m3)
    rgb = torch.stack(rows, dim=-1)
    return (rgb * 255.0 + 0.5).clamp(0, 255).to(torch.uint8)

"""In-loop deblocking filter (NumPy reference backend).

Reference: h264bsd_deblocking.c:574 h264bsdFilterPicture — raster MB scan,
per-MB vertical edges left-to-right then horizontal edges top-to-bottom,
boundary strengths from intra/coeff/MV conditions (:331-:1134), alpha/beta/
tc0 threshold tables (:77-:102).
"""

from __future__ import annotations

import numpy as np

from ..bitstream.mb_layer import PictureData
from .recon_cpu import Frame


def filter_picture(frame: Frame, pic: PictureData,
                   chroma_qp_offset: int) -> None:
    if all(sp.disable_deblocking_idc == 1 for sp in pic.slice_params):
        return
    from .deblock_impl import filter_picture_impl
    filter_picture_impl(frame, pic, chroma_qp_offset)

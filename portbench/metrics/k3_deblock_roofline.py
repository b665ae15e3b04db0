"""k3_deblock_roofline: K3 (csrc/deblock.cu), in-loop deblocking, as a
share in % of its HBM roofline over the clients' traces: the bytes that
the traced pictures need of it (``roofline.k3_deblock_bytes``, from the
manifest's macroblock classes) against the summed device time of the
kernels named ``deblock_rows_kernel``."""

from __future__ import annotations

from .. import roofline
from . import _traced

UNIT = "%"


def read(run: dict):
    return _traced.kernel_roofline(run, "deblock_rows_kernel",
                                   roofline.k3_deblock_bytes)

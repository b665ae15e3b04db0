"""k2_intra_roofline: K2 (csrc/intra.cu), intra prediction and
reconstruction, as a share in % of its
HBM roofline over the clients' traces: the bytes that the traced
pictures need of it (``roofline.k2_intra_bytes``, from the manifest's
macroblock classes) against the summed device time of the kernels named
``intra_rows_kernel``."""

from __future__ import annotations

from .. import roofline
from . import _traced

UNIT = "%"


def read(run: dict):
    return _traced.kernel_roofline(run, "intra_rows_kernel",
                                   roofline.k2_intra_bytes)

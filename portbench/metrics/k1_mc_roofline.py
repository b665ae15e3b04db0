"""k1_mc_roofline: K1 (csrc/mc.cu), motion compensation, as a share in % of its
HBM roofline over the clients' traces: the bytes that the traced
pictures need of it (``roofline.k1_mc_bytes``, from the manifest's
macroblock classes) against the summed device time of the kernels named
``mc_kernel``."""

from __future__ import annotations

from .. import roofline
from . import _traced

UNIT = "%"


def read(run: dict):
    return _traced.kernel_roofline(run, "mc_kernel", roofline.k1_mc_bytes)

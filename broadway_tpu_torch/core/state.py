"""State carried across pictures, and its conversion from the JAX package.

The port keeps its reference-plane stacks as UNPADDED uint8:
``ref_y [R, H, W]`` and ``ref_c [R, 2, H/2, W/2]`` (cb, cr). The JAX
package keeps them edge-replicated by PAD = 24, DMA-extended, int32,
with cb/cr interleaved on the lane axis (``ops/tpu/mc_pallas.pad_luma``
/ ``pad_chroma``). With PAD >= the 10x10 MC window, the JAX origin clip
into the edge-replicated plane equals a per-pixel clamp into the
unpadded plane, which is what the port's MC does, so the interior is all
the state there is.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

PAD = 24   # the JAX stack format's edge-replication pad


def ref_stacks_from_jax(ref_y: np.ndarray, ref_c: np.ndarray, width: int,
                        height: int, device="cpu"
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """JAX-format padded int32 stacks (numpy) -> the port's stacks.

    ref_y [R, HyE, WyE] (pad_luma), ref_c [R, HcE, WcE] (pad_chroma).
    Returns uint8 ref_y [R, H, W] and ref_c [R, 2, H/2, W/2]."""
    ref_y = np.asarray(ref_y)
    ref_c = np.asarray(ref_c)
    hc, wc = height // 2, width // 2
    y = ref_y[:, PAD:PAD + height, PAD:PAD + width]
    il = ref_c[:, PAD:PAD + hc, 2 * PAD:2 * (PAD + wc)]
    c = il.reshape(il.shape[0], hc, wc, 2).transpose(0, 3, 1, 2)
    return (torch.as_tensor(np.ascontiguousarray(y, np.uint8),
                            device=device),
            torch.as_tensor(np.ascontiguousarray(c, np.uint8),
                            device=device))


def tables_from_numpy(arrays: Dict[str, np.ndarray], device="cpu"
                      ) -> Dict[str, torch.Tensor]:
    """A dict of numpy arrays (per-MB picture arrays as
    ``recon_tpu.host_picture_arrays`` makes them, or constant tables) ->
    torch tensors on `device`: bool stays bool, every integer type
    becomes int32, as the JAX pipeline treats them."""
    out = {}
    for k, v in arrays.items():
        v = np.asarray(v)
        v = np.array(v, dtype=np.bool_ if v.dtype == np.bool_ else np.int32,
                     order="C")
        out[k] = torch.from_numpy(v).to(device)
    return out

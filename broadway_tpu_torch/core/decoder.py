"""Decoder with the torch pixel backend.

The host engine (NAL dispatch, parameter sets, slice parsing on the
native front end, DPB/POC, output order, concealment) is
``broadway_tpu.core.decoder.Decoder``, shared unchanged; this subclass
only supplies picture reconstruction on a torch device (twin of the
base class's ``_ensure_stacks`` / ``_reconstruct_tpu`` packed-v2 path,
``_reconstruct_concealed`` and ``load_state``).

It passes ``backend="torch"``, so none of the base class's TPU-only
machinery (async pump, frame groups, compile cache) turns on, and it
installs its own method as the base class's ``recon_strategy`` hook,
which is how the base class reaches a pixel backend other than its own.
"""

from __future__ import annotations

import torch

from broadway_tpu.bitstream import native as nat
from broadway_tpu.core import packed as PK
from broadway_tpu.core.decoder import Decoder as BaseDecoder

from .recon import TorchFrame, decode_picture_packed2, update_stack_slot


class Decoder(BaseDecoder):
    """Single-stream H.264 Baseline decoder reconstructing on `device`
    ("cuda" runs the hand-written kernels, "cpu" their plain versions)."""

    def __init__(self, device="cuda", parallel_slices: int = 0,
                 no_reordering: bool = False, frontend: str = "auto",
                 recon_strategy=None) -> None:
        if recon_strategy is not None:
            raise ValueError("the torch Decoder installs its own "
                             "recon_strategy; it cannot take another")
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Decoder(device='cuda'): CUDA is not "
                               "available")
        if device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {device}")
        super().__init__(no_reordering=no_reordering, backend="torch",
                         frontend=frontend, parallel_slices=parallel_slices,
                         recon_strategy=type(self)._reconstruct_torch)
        self.device = device
        self._dstack_key = None
        self._stack_y = self._stack_c = None
        self._pack2_scratch = None

    # ------------------------------------------------------------------
    def _upload_frame_slot(self, slot: int, frame) -> TorchFrame:
        """Write a frame (host planes or a TorchFrame) into stack slot
        `slot`; returns it as a TorchFrame."""
        if not isinstance(frame, TorchFrame):
            frame = TorchFrame.from_planes(frame.y, frame.cb, frame.cr,
                                           self.device)
        update_stack_slot(self._stack_y, self._stack_c, slot, frame)
        return frame

    def _ensure_stacks(self) -> None:
        """(Re)create the reference-plane stacks for the active sequence
        (R = dpb_size + 1 slots), seeding them from any DPB frames
        already present (load_state / concealed-first-picture paths)."""
        sps = self.sps
        R = self.dpb.dpb_size + 1
        key = (sps.width_mbs, sps.height_mbs, R)
        if self._dstack_key == key:
            return
        H, W = sps.height, sps.width
        self._stack_y = torch.zeros((R, H, W), dtype=torch.uint8,
                                    device=self.device)
        self._stack_c = torch.zeros((R, 2, H // 2, W // 2),
                                    dtype=torch.uint8, device=self.device)
        self._dstack_key = key
        for p in self.dpb.buffer:
            if p.frame is not None and not p.non_existing \
                    and p is not self.dpb.current:
                self._upload_frame_slot(p.slot, p.frame)

    def _reconstruct_torch(self, pic) -> TorchFrame:
        """recon_strategy: pack, upload, reconstruct, write the slot."""
        if not nat.pack2_available():
            raise NotImplementedError(
                "the native front-end library (native/build.sh) is missing; "
                "the torch port has only the packed-v2 path (the unpacked "
                "and v1 paths are not ported yet, see ROADMAP.md)")
        sps, pps = self.sps, self.pps
        lay = PK.get_packed_layout_v2(sps.width_mbs, sps.height_mbs)
        if self._pack2_scratch is None or self._pack2_scratch.lay is not lay:
            self._pack2_scratch = PK.PackScratchV2(lay)
        res = PK.pack_picture_v2(pic, lay, self._pack2_scratch)
        if res is None:
            raise NotImplementedError(
                "picture does not fit the packed-v2 format (more than 1024 "
                "slices); the v1 fallback is not ported yet, see "
                "ROADMAP.md")
        self._ensure_stacks()
        buf, bk = res
        dbuf = torch.from_numpy(buf).to(self.device)
        return decode_picture_packed2(
            dbuf, self._stack_y, self._stack_c, self.dpb.current.slot, lay,
            bk, constrained_intra=pps.constrained_intra_pred,
            chroma_qp_offset=pps.chroma_qp_index_offset)

    def _reconstruct_concealed(self, pic, num_err: int) -> TorchFrame:
        """Host concealment (base class), then the concealed frame goes
        into the current stack slot, so later P pictures predict from it
        and not from a stale slot."""
        frame = super()._reconstruct_concealed(pic, num_err)
        self._ensure_stacks()
        return self._upload_frame_slot(self.dpb.current.slot, frame)

    def load_state(self, st: dict) -> None:
        """Restore a save_state() snapshot, also one taken by the JAX
        package's decoder: frames become TorchFrames, and the stacks are
        rebuilt from their planes when the next picture starts (the base
        class resets the stack key)."""
        super().load_state(st)
        for p in (self.dpb.buffer if self.dpb is not None else ()):
            if p.frame is not None:
                p.frame = TorchFrame.from_planes(p.frame.y, p.frame.cb,
                                                 p.frame.cr, self.device)

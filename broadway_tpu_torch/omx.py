"""OMX-IL-style embedding component of the port — the analogue of the
reference's Android `SoftAVC` (Decoder/SoftAVC.cpp/.h: SoftAVC :
SimpleSoftOMXComponent, 8 input / 2 output buffers SoftAVC.h:53-56,
onQueueFilled :289 drives H264SwDecDecode, port-settings-change on
resolution events updatePortDefinitions :536, crop events, EOS drain
drainAllOutputBuffers).

The production embedding contract this models:
  - input buffers queue compressed NALs; the component consumes them
    with the L3 API (api.H264Decoder);
  - when the stream publishes new dimensions (first headers or a
    mid-stream resolution change at IDR), the component emits a
    PORT_SETTINGS_CHANGED event and STOPS emitting output until the
    client acknowledges with reconfigure_output() — exactly OMX's
    output-port disable/re-enable handshake;
  - an input buffer flagged EOS causes every remaining decoded picture
    to be drained, the last one carrying the EOS flag.

Counterpart of ``broadway_tpu/omx.py`` (the same events, queues and
flags) on the port's ``api.H264Decoder``: ``device="cuda"|"cpu"`` in
place of ``backend=``, "cuda" by default; an output buffer's ``frame``
is the port's ``TorchFrame``, resident on that device.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable, List, Optional, Tuple

from .api import DecRet, H264Decoder
from .core.decoder import OutputPicture


class Event(enum.Enum):
    PORT_SETTINGS_CHANGED = 1      # output dims changed; reconfigure
    CROP_CHANGED = 2               # crop rectangle changed


@dataclasses.dataclass
class OutputBuffer:
    data: bytes                    # raw display-order YUV420
    width: int
    height: int
    crop: Optional[tuple]
    pic_id: int
    eos: bool = False
    frame: object = None           # TorchFrame (device planes)


@dataclasses.dataclass
class PortDef:
    width: int = 0
    height: int = 0
    buffer_count: int = 0
    enabled: bool = True


class SoftAvc:
    """Minimal OMX-like H.264 decoder component."""

    NUM_INPUT_BUFFERS = 8          # SoftAVC.h:53-56
    NUM_OUTPUT_BUFFERS = 2

    def __init__(self, device="cuda",
                 event_cb: Callable[[Event, tuple], None] = None) -> None:
        self._dec = H264Decoder(device=device, streaming=True)
        self._event_cb = event_cb or (lambda ev, args: None)
        self._in_q: List[Tuple[bytes, bool]] = []
        self._out_q: List[OutputBuffer] = []
        self._eos_in = False
        self._eos_sent = False
        self.input_port = PortDef(buffer_count=self.NUM_INPUT_BUFFERS)
        self.output_port = PortDef(buffer_count=self.NUM_OUTPUT_BUFFERS)
        self._dims: Optional[Tuple[int, int]] = None
        self._crop = None
        self._settings_pending = False

    # -- client side -----------------------------------------------------
    def queue_input(self, data: bytes, eos: bool = False) -> bool:
        """Queue one compressed buffer (False when the input port is
        full — the client must dequeue outputs / wait)."""
        if len(self._in_q) >= self.input_port.buffer_count:
            return False
        self._in_q.append((data, eos))
        self.process()
        return True

    def dequeue_output(self) -> Optional[OutputBuffer]:
        """Pop one decoded display-order frame, or None."""
        self.process()
        if not self._out_q:
            return None
        return self._out_q.pop(0)

    def reconfigure_output(self) -> None:
        """Client acknowledgment of PORT_SETTINGS_CHANGED: re-enables
        the output port at the published geometry (the OMX output port
        disable -> allocate -> enable cycle, SoftAVC updatePort
        Definitions :536)."""
        self._settings_pending = False
        self.output_port.enabled = True
        self.process()

    @property
    def eos_delivered(self) -> bool:
        return self._eos_sent

    # -- component side (onQueueFilled analogue) -------------------------
    def _publish_dims(self, w: int, h: int, crop) -> None:
        if (w, h) != self._dims:
            self._dims = (w, h)
            self.output_port.width = w
            self.output_port.height = h
            self.output_port.enabled = False
            self._settings_pending = True
            self._event_cb(Event.PORT_SETTINGS_CHANGED, (w, h))
        if crop != self._crop:
            self._crop = crop
            self._event_cb(Event.CROP_CHANGED, (crop,))

    def _emit(self, pic) -> None:
        self._out_q.append(OutputBuffer(
            data=pic.output_picture, width=pic.width, height=pic.height,
            crop=pic.crop, pic_id=pic.pic_id, frame=pic.frame))

    def _pump_outputs(self, flush: bool) -> bool:
        """Move decoded pictures to the output queue while the port is
        enabled; returns False when blocked on settings change."""
        while len(self._out_q) < self.output_port.buffer_count * 4:
            if self._settings_pending:
                return False
            pic = self._dec.next_picture(flush=flush)
            if pic is None:
                if flush and not self._eos_sent:
                    if self._out_q:
                        # mark the final decoded frame as EOS
                        self._out_q[-1].eos = True
                    else:
                        # EOS with nothing pending: an empty EOS buffer
                        self._out_q.append(OutputBuffer(
                            data=b"", width=self.output_port.width,
                            height=self.output_port.height,
                            crop=self._crop, pic_id=-1, eos=True))
                    self._eos_sent = True
                return True
            if (pic.width, pic.height) != self._dims:
                self._publish_dims(pic.width, pic.height, pic.crop)
                if self._settings_pending:
                    # re-queue: deliver after reconfigure
                    self._dec._pending.insert(0, _requeue(pic))
                    return False
            self._emit(pic)
        return True

    def process(self) -> None:
        """Drive decode: consume queued input, surface events, fill
        outputs (the onQueueFilled :289 loop)."""
        while True:
            if self._settings_pending:
                return
            if not self._pump_outputs(flush=self._eos_in
                                      and not self._in_q):
                return
            if self._eos_sent or not self._in_q:
                return
            data, eos = self._in_q.pop(0)
            if eos:
                self._eos_in = True
            rest = data
            while rest:
                ret, used = self._dec.decode(rest)
                if ret in (DecRet.HDRS_RDY,
                           DecRet.HDRS_RDY_BUFF_NOT_EMPTY):
                    info = self._dec.get_info()
                    if info is not None:
                        self._publish_dims(info.pic_width,
                                           info.pic_height,
                                           info.crop_params)
                if used <= 0:
                    break
                rest = rest[used:]


def _requeue(pic):
    """Wrap a DecPicture back into the core's pending-output shape."""
    return OutputPicture(frame=pic.frame, is_idr=pic.is_idr,
                         pic_id=pic.pic_id,
                         num_err_mbs=pic.nbr_of_err_mbs,
                         width=pic.width, height=pic.height,
                         crop=pic.crop)

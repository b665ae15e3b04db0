"""Player orchestration — analogue of Player/Player.js (options, decode
dispatch, render path selection) and Player/mp4.js MP4Player (per-sample
NAL feeding, fps statistics :772-837).

The reference's worker plumbing (postMessage, transferable buffers,
buffer recycling) maps to CUDA's asynchronous launches: decode calls
enqueue device work; frames stay device-resident until rendered/fetched.

Counterpart of ``broadway_tpu/player/player.py`` on the port's
``api.H264Decoder``: ``device="cuda"|"cpu"`` in place of ``backend=``,
"cuda" by default. With a `render` other than "yuv" the converted
picture is a tensor on the frame's device (``player/yuv2rgb.py`` reads
the frame's device planes directly).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional

from ..api import H264Decoder
from .mp4 import MP4Reader
from .yuv2rgb import yuv420_to_rgba_int, yuv_to_rgb_rec601, \
    yuv_to_rgb_rec709


@dataclasses.dataclass
class FpsStats:
    """Rolling fps statistics (mirror of mp4.js updateStatistics)."""

    window_start: float = 0.0
    window_frames: int = 0
    start_time: float = 0.0
    total_frames: int = 0
    fps: float = 0.0
    fps_min: float = float("inf")
    fps_max: float = float("-inf")
    fps_since_start: float = 0.0
    score: Optional[float] = None        # fpsSinceStart at frame 1200

    def tick(self, now: float = None) -> None:
        now = time.perf_counter() if now is None else now
        if self.total_frames == 0:
            self.start_time = now
            self.window_start = now
        self.total_frames += 1
        self.window_frames += 1
        dt = now - self.window_start
        if dt > 1.0:
            self.fps = self.window_frames / dt
            self.fps_min = min(self.fps_min, self.fps)
            self.fps_max = max(self.fps_max, self.fps)
            self.window_start = now
            self.window_frames = 0
        total_dt = now - self.start_time
        if total_dt > 0:
            self.fps_since_start = self.total_frames / total_dt
        if self.total_frames == 1200 and self.score is None:
            self.score = self.fps_since_start


# render option -> (key of the picture dict, converter of device planes)
RENDERERS = {"yuv": ("yuv", None),
             "rgb_int": ("rgba", yuv420_to_rgba_int),
             "rec601": ("rgb", yuv_to_rgb_rec601),
             "rec709": ("rgb", yuv_to_rgb_rec709)}


class Player:
    """Decode + render pipeline.

    options (mirror Player.js:46-98):
      device: "cuda" | "cpu"  (the useWorker analogue: device offload)
      render:  "yuv" (no conversion), "rgb_int" (asm.js-math converter),
               "rec601" / "rec709" (WebGL-shader-matrix path)
      on_picture: callback(frame_dict) per display-order picture; the
               dict also carries the decoded "frame" (a TorchFrame)
    """

    def __init__(self, device="cuda", render: str = "yuv",
                 on_picture: Optional[Callable] = None,
                 no_output_reordering: bool = False) -> None:
        if render not in RENDERERS:
            raise ValueError(f"unknown render {render!r}; one of "
                             f"{sorted(RENDERERS)}")
        self.decoder = H264Decoder(no_output_reordering=no_output_reordering,
                                   device=device)
        self.render = render
        self.on_picture = on_picture
        self.stats = FpsStats()
        self.frames: List[dict] = []

    # ------------------------------------------------------------------
    def decode(self, data: bytes) -> None:
        """Feed one chunk (NALs with start codes)."""
        buf = data
        while buf:
            ret, used = self.decoder.decode(buf)
            self._drain()
            if used <= 0:
                break
            buf = buf[used:]

    def end_of_stream(self) -> None:
        self._drain(flush=True)

    def _drain(self, flush: bool = False) -> None:
        while True:
            pic = self.decoder.next_picture(flush=flush)
            if pic is None:
                return
            self.stats.tick()
            out = {"width": pic.width, "height": pic.height,
                   "pic_id": pic.pic_id, "is_idr": pic.is_idr,
                   "nbr_of_err_mbs": pic.nbr_of_err_mbs}
            f = out["frame"] = pic.frame     # stays on its device
            key, convert = RENDERERS[self.render]
            if convert is None:
                out[key] = pic.output_picture
            else:
                out[key] = convert(f.dev_y, f.dev_cb, f.dev_cr)
            if self.on_picture:
                self.on_picture(out)
            else:
                self.frames.append(out)


class MP4Player:
    """Demux an MP4 and feed the video track sample-by-sample
    (mirror of mp4.js MP4Player :758-881)."""

    def __init__(self, data: bytes, **player_opts) -> None:
        self.reader = MP4Reader(data).read()
        self.track = self.reader.video_track
        if self.track is None or self.track.avcc is None:
            raise ValueError("no AVC video track")
        self.player = Player(**player_opts)
        self.data = data

    def play(self) -> Player:
        avcc = self.track.avcc
        for ps in avcc.sps + avcc.pps:
            self.player.decode(b"\x00\x00\x00\x01" + ps)
        for s in range(self.track.sample_count):
            for nal in self.track.sample_nal_units(self.data, s):
                self.player.decode(b"\x00\x00\x00\x01" + nal)
        self.player.end_of_stream()
        return self.player

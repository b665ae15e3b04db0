#!/usr/bin/env python3
"""External H.264 encoder through the system's libavcodec / libx264
(ctypes): the port's own copy of the repository's
``tools/ext_encoder.py``, with the same functions.

Every other fixture of the repository comes from its own generator
(``tools/h264enc.py``, ``tools/streams.py``). This module makes
Baseline / CAVLC Annex-B streams with a third-party encoder, x264, for
golden tests and for the committed 1080p fixture under ``tools/data/``
(the reference's clip recipe, README.markdown:35: -coder 0 -bf 0
-wpredp 0, which is x264's baseline profile).

Only the shared libraries are needed, no ffmpeg CLI and no headers: the
binding is ctypes against the stable public API. Struct offsets are used
only for AVFrame / AVPacket fields whose layout is fixed within
libavutil 57 / libavcodec 59, and are checked at run time by sentinels
(frame.format == -1, packet pts / dts == AV_NOPTS). It imports ctypes
and NumPy only.
"""

from __future__ import annotations

import ctypes as ct
from typing import Iterable, Optional

import numpy as np

AV_NOPTS = -0x8000000000000000
_AV_OPT_SEARCH_CHILDREN = 1

# AVFrame field offsets (libavutil 57, ffmpeg 5.x; verified at runtime)
_F_DATA = 0          # uint8_t *data[8]
_F_LINESIZE = 64     # int linesize[8]
_F_WIDTH = 104
_F_HEIGHT = 108
_F_FORMAT = 116
_F_PTS = 136
_PIX_FMT_YUV420P = 0

# AVPacket field offsets (libavcodec 59)
_P_PTS = 8
_P_DTS = 16
_P_DATA = 24
_P_SIZE = 32

_libs = None


def _load():
    global _libs
    if _libs is not None:
        return _libs
    try:
        avu = ct.CDLL("libavutil.so.57")
        avc = ct.CDLL("libavcodec.so.59")
    except OSError:
        _libs = False
        return False
    for f, res, args in [
        (avc.avcodec_find_encoder_by_name, ct.c_void_p, [ct.c_char_p]),
        (avc.avcodec_alloc_context3, ct.c_void_p, [ct.c_void_p]),
        (avc.avcodec_open2, ct.c_int,
         [ct.c_void_p, ct.c_void_p, ct.c_void_p]),
        (avc.avcodec_send_frame, ct.c_int, [ct.c_void_p, ct.c_void_p]),
        (avc.avcodec_receive_packet, ct.c_int, [ct.c_void_p, ct.c_void_p]),
        (avc.av_packet_alloc, ct.c_void_p, []),
        (avc.av_packet_unref, None, [ct.c_void_p]),
        (avu.av_frame_alloc, ct.c_void_p, []),
        (avu.av_frame_get_buffer, ct.c_int, [ct.c_void_p, ct.c_int]),
        (avu.av_frame_make_writable, ct.c_int, [ct.c_void_p]),
        (avu.av_opt_set, ct.c_int,
         [ct.c_void_p, ct.c_char_p, ct.c_char_p, ct.c_int]),
    ]:
        f.restype = res
        f.argtypes = args
    _libs = (avu, avc)
    return _libs


def available() -> bool:
    libs = _load()
    if not libs:
        return False
    avu, avc = libs
    if not avc.avcodec_find_encoder_by_name(b"libx264"):
        return False
    # runtime ABI sentinels
    fr = avu.av_frame_alloc()
    ok = ct.c_int.from_address(fr + _F_FORMAT).value == -1
    pkt = avc.av_packet_alloc()
    ok &= ct.c_int64.from_address(pkt + _P_PTS).value == AV_NOPTS
    ok &= ct.c_int64.from_address(pkt + _P_DTS).value == AV_NOPTS
    return bool(ok)


def encode_annexb(frames: Iterable[np.ndarray], width: int, height: int,
                  fps: int = 30, crf: int = 23, slices: int = 1,
                  keyint: int = 60, refs: int = 3,
                  x264_params: Optional[str] = None) -> bytes:
    """Encode YUV420 frames, each a (y, cb, cr) tuple of u8 planes, to a
    Baseline-profile Annex-B byte stream via libx264."""
    avu, avc = _load()
    codec = avc.avcodec_find_encoder_by_name(b"libx264")
    assert codec, "libx264 encoder not available"
    ctx = avc.avcodec_alloc_context3(codec)

    def opt(k, v):
        r = avu.av_opt_set(ctx, k.encode(), str(v).encode(),
                           _AV_OPT_SEARCH_CHILDREN)
        assert r == 0, f"av_opt_set({k}={v}) -> {r}"

    opt("video_size", f"{width}x{height}")
    opt("pixel_format", "yuv420p")
    opt("time_base", f"1/{fps}")
    opt("g", keyint)
    opt("bf", 0)
    opt("refs", refs)
    opt("threads", 1)             # deterministic output
    opt("profile", "baseline")    # CAVLC, no B, no weighted pred
    opt("preset", "medium")
    opt("crf", crf)
    params = f"slices={slices}:scenecut=0"
    if x264_params:
        params += ":" + x264_params
    opt("x264-params", params)

    r = avc.avcodec_open2(ctx, codec, None)
    assert r == 0, f"avcodec_open2 -> {r}"

    frame = avu.av_frame_alloc()
    ct.c_int.from_address(frame + _F_WIDTH).value = width
    ct.c_int.from_address(frame + _F_HEIGHT).value = height
    ct.c_int.from_address(frame + _F_FORMAT).value = _PIX_FMT_YUV420P
    r = avu.av_frame_get_buffer(frame, 32)
    assert r == 0

    pkt = avc.av_packet_alloc()
    out = []

    def drain():
        while True:
            r = avc.avcodec_receive_packet(ctx, pkt)
            if r != 0:
                return
            size = ct.c_int.from_address(pkt + _P_SIZE).value
            data = ct.c_void_p.from_address(pkt + _P_DATA).value
            out.append(ct.string_at(data, size))
            avc.av_packet_unref(pkt)

    n = 0
    for f in frames:
        if not isinstance(f, tuple):
            raise ValueError("pass (y, cb, cr) tuples")
        y, cb, cr = f
        avu.av_frame_make_writable(frame)
        for pi, plane in enumerate((y, cb, cr)):
            dst = ct.c_void_p.from_address(frame + _F_DATA + 8 * pi).value
            ls = ct.c_int.from_address(frame + _F_LINESIZE + 4 * pi).value
            ph, pw = plane.shape
            src = np.ascontiguousarray(plane, np.uint8)
            if ls == pw:
                ct.memmove(dst, src.ctypes.data, ph * pw)
            else:
                for row in range(ph):
                    ct.memmove(dst + row * ls,
                               src.ctypes.data + row * pw, pw)
        ct.c_int64.from_address(frame + _F_PTS).value = n
        n += 1
        r = avc.avcodec_send_frame(ctx, frame)
        assert r == 0, f"send_frame -> {r}"
        drain()
    r = avc.avcodec_send_frame(ctx, None)   # flush
    drain()
    return b"".join(out)


def natural_frames(width: int, height: int, n_frames: int, seed: int = 0):
    """Synthesized natural-ish content: moving gradients, textured
    regions, translating objects — realistic MC/residual statistics."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    tex = rng.randint(-18, 18, (height + 64, width + 64)).astype(np.float32)
    # smooth the texture a little (box blur)
    k = 3
    c = np.cumsum(np.cumsum(tex, 0), 1)
    tex[k:-k, k:-k] = (c[2 * k:, 2 * k:] - c[:-2 * k, 2 * k:]
                       - c[2 * k:, :-2 * k] + c[:-2 * k, :-2 * k]) \
        / (4 * k * k)
    objs = [(rng.randint(0, width), rng.randint(0, height),
             rng.uniform(-3, 3), rng.uniform(-2, 2),
             rng.randint(16, 64), rng.randint(64, 200))
            for _ in range(6)]
    for t in range(n_frames):
        gx = 0.7 * t
        gy = 0.3 * t
        y = (96 + 60 * np.sin((xx + gx * 4) / 64.0)
             + 40 * np.cos((yy + gy * 4) / 48.0))
        y += tex[int(gy) % 32:int(gy) % 32 + height,
                 int(gx) % 32:int(gx) % 32 + width]
        for (ox, oy, vx, vy, sz, lum) in objs:
            x0 = int(ox + vx * t) % width
            y0 = int(oy + vy * t) % height
            y[y0:y0 + sz, x0:x0 + sz] = lum + tex[:sz, :sz][
                :min(sz, height - y0), :min(sz, width - x0)] * 0.5
        yq = np.clip(y, 0, 255).astype(np.uint8)
        cb = np.clip(128 + 30 * np.sin((xx[::2, ::2] + 2 * t) / 80.0),
                     0, 255).astype(np.uint8)
        cr = np.clip(128 + 30 * np.cos((yy[::2, ::2] - 3 * t) / 60.0),
                     0, 255).astype(np.uint8)
        yield yq, cb, cr


def encode_natural(width: int, height: int, n_frames: int, seed: int = 0,
                   **kw) -> bytes:
    return encode_annexb(natural_frames(width, height, n_frames, seed),
                         width, height, **kw)


if __name__ == "__main__":
    import sys
    w, h, n = (int(x) for x in sys.argv[1:4])
    out = sys.argv[4]
    data = encode_natural(w, h, n, slices=int(sys.argv[5])
                          if len(sys.argv) > 5 else 1)
    with open(out, "wb") as f:
        f.write(data)
    print(f"wrote {out}: {len(data)} bytes")

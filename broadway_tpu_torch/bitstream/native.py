"""ctypes binding for the native (C++) slice-data front end and v2
packer (``csrc/frontend.cpp``, built by ``ops/gpu/_build.py`` into
``build/torch_kernels/libbw_frontend_<hash>.so``).

Drop-in replacement for the Python ``decode_slice_data`` hot path; the
Python implementation stays as the readable reference, taken only when
the caller asks for ``frontend="python"``. A library that cannot be
built or loaded raises with the compiler's output: nothing here gives
way to the Python parser quietly. The ctypes structures below mirror
``SliceInfo`` and ``PicBuffers`` of ``frontend.cpp`` field for field.
"""

from __future__ import annotations

import ctypes as ct
import threading
from typing import List, Optional

import numpy as np

from ..ops.gpu import _build
from .frontend import SliceDataError
from .mb_layer import MbParser, PictureData, SliceParams
from .slice_header import SliceHeader

_lock = threading.Lock()
_lib = None


class _SliceInfo(ct.Structure):
    _fields_ = [("w_mbs", ct.c_int32), ("h_mbs", ct.c_int32),
                ("slice_type", ct.c_int32), ("first_mb", ct.c_int32),
                ("slice_qp", ct.c_int32), ("num_ref", ct.c_int32),
                ("slice_id", ct.c_int32),
                ("constrained_intra", ct.c_int32)]


_PTR_FIELDS = [
    "mb_class", "skip", "qp", "cbp", "i16_mode", "chroma_mode", "i4_modes",
    "luma_coeffs", "luma_dc", "chroma_dc", "chroma_ac", "total_coeff",
    "chroma_total_coeff", "mv", "ref_idx", "ref_slot", "ipcm", "slice_id",
    "decoded", "mv_grid", "ref_grid", "tc_grid", "ctc_grid", "i4_grid",
]


class _PicBuffers(ct.Structure):
    _fields_ = [(f, ct.c_void_p) for f in _PTR_FIELDS]


def load() -> ct.CDLL:
    """The loaded front-end library, built on first call. Raises
    RuntimeError (build) or OSError (load) on failure."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ct.CDLL(_build.build_frontend())
            lib.bw_decode_slice_data.restype = ct.c_int
            lib.bw_decode_slice_data.argtypes = [
                ct.c_char_p, ct.c_int64, ct.c_int64, ct.POINTER(_SliceInfo),
                ct.c_void_p, ct.c_void_p, ct.POINTER(_PicBuffers),
                ct.POINTER(ct.c_int32), ct.POINTER(ct.c_int64)]
            lib.bw_pack_picture2.restype = ct.c_int
            lib.bw_pack_picture2.argtypes = [
                ct.POINTER(_PicBuffers), ct.c_int32, ct.c_void_p, ct.c_int32,
                ct.c_void_p, ct.c_void_p, ct.c_void_p,
                ct.c_void_p, ct.c_void_p, ct.c_void_p, ct.c_void_p,
                ct.POINTER(ct.c_int32), ct.POINTER(ct.c_int32),
                ct.POINTER(ct.c_int32)]
            _lib = lib
    return _lib


def _ptr(a: np.ndarray):
    if not a.flags["C_CONTIGUOUS"]:
        raise ValueError("the native front end takes C-contiguous arrays")
    return a.ctypes.data_as(ct.c_void_p)


def append_slice_params(pic: PictureData, header: SliceHeader,
                        slice_id: int, ref_slots: List[int]) -> None:
    pic.slice_params.append(SliceParams(
        slice_type=header.slice_type,
        disable_deblocking_idc=header.disable_deblocking_idc,
        alpha_c0_offset=header.alpha_c0_offset,
        beta_offset=header.beta_offset,
        ref_slots=list(ref_slots)))
    if len(pic.slice_params) != slice_id + 1:
        raise RuntimeError("slice params out of step with the slice count")


def _pic_buffers(pic: PictureData, parser: Optional[MbParser] = None
                 ) -> _PicBuffers:
    pb = _PicBuffers()
    pb.mb_class = _ptr(pic.mb_class)
    pb.skip = _ptr(pic.skip)
    pb.qp = _ptr(pic.qp)
    pb.cbp = _ptr(pic.cbp)
    pb.i16_mode = _ptr(pic.i16_mode)
    pb.chroma_mode = _ptr(pic.chroma_mode)
    pb.i4_modes = _ptr(pic.i4_modes)
    pb.luma_coeffs = _ptr(pic.luma_coeffs)
    pb.luma_dc = _ptr(pic.luma_dc)
    pb.chroma_dc = _ptr(pic.chroma_dc)
    pb.chroma_ac = _ptr(pic.chroma_ac)
    pb.total_coeff = _ptr(pic.total_coeff)
    pb.chroma_total_coeff = _ptr(pic.chroma_total_coeff)
    pb.mv = _ptr(pic.mv)
    pb.ref_idx = _ptr(pic.ref_idx)
    pb.ref_slot = _ptr(pic.ref_slot)
    pb.ipcm = _ptr(pic.ipcm)
    pb.slice_id = _ptr(pic.slice_id)
    pb.decoded = _ptr(pic.decoded)
    if parser is not None:
        pb.mv_grid = _ptr(parser.mv_grid)
        pb.ref_grid = _ptr(parser.ref_grid)
        pb.tc_grid = _ptr(parser.tc_grid)
        pb.ctc_grid = _ptr(parser.ctc_grid)
        pb.i4_grid = _ptr(parser.i4_grid)
    return pb


def pack_picture2_native(pic: PictureData, base, idx8, val8, idx16,
                         val16, eidx, eval_) -> tuple:
    """Fill the COMPACT packed upload buffer (v2: 13 B/MB base +
    slice-param table + two-tier sparse coefficient rows (i8 / i16) +
    sparse exception rows). Returns (n i8 rows, n i16 rows, n exc)."""
    lib = load()
    pb = _pic_buffers(pic)
    sp = np.array([[p.disable_deblocking_idc, p.alpha_c0_offset,
                    p.beta_offset] for p in pic.slice_params] or [[0, 0, 0]],
                  np.int32)
    k8 = ct.c_int32(0)
    k = ct.c_int32(0)
    e = ct.c_int32(0)
    ret = lib.bw_pack_picture2(ct.byref(pb), pic.n_mbs, _ptr(sp), len(sp),
                               _ptr(base), _ptr(idx8), _ptr(val8),
                               _ptr(idx16), _ptr(val16),
                               _ptr(eidx), _ptr(eval_),
                               ct.byref(k8), ct.byref(k), ct.byref(e))
    if ret != 0:
        raise RuntimeError(f"bw_pack_picture2 failed ({ret})")
    return int(k8.value), int(k.value), int(e.value)


def decode_slice_data_native(rbsp: bytes, bit_pos: int, pic: PictureData,
                             parser: MbParser, header: SliceHeader,
                             sps, pps, sg_map: np.ndarray, slice_id: int,
                             ref_slots: List[int],
                             append_params: bool = True) -> int:
    """Native twin of frontend.decode_slice_data; returns final bit pos.
    Raises SliceDataError on stream errors (with last_mb_addr).
    The ctypes call releases the GIL, so independent slices of one
    picture can parse concurrently on a thread pool (entropy and
    prediction contexts are slice-local in Baseline H.264)."""
    lib = load()

    if append_params:
        append_slice_params(pic, header, slice_id, ref_slots)

    si = _SliceInfo(
        w_mbs=pic.width_mbs, h_mbs=pic.height_mbs,
        slice_type=header.slice_type, first_mb=header.first_mb,
        slice_qp=header.slice_qp, num_ref=header.num_ref_idx_l0,
        slice_id=slice_id,
        constrained_intra=int(parser.constrained_intra))

    pb = _pic_buffers(pic, parser)

    sg = np.ascontiguousarray(sg_map, np.int32)
    rs = np.ascontiguousarray(
        np.array(ref_slots if ref_slots else [-1], np.int32))
    last = ct.c_int32(0)
    out_pos = ct.c_int64(0)
    ret = lib.bw_decode_slice_data(
        rbsp, len(rbsp), bit_pos, ct.byref(si), _ptr(sg), _ptr(rs),
        ct.byref(pb), ct.byref(last), ct.byref(out_pos))
    if ret != 0:
        raise SliceDataError("native slice data error", int(last.value))
    return int(out_pos.value)

"""The port's public decoder API (``broadway_tpu_torch/api.py``) held
against the JAX package's (``broadway_tpu/api.py``) on the same bytes:
the same streams, fed whole, in chunks with ``streaming=True``, packet
by packet and as bare NAL units, go through
``broadway_tpu.api.H264Decoder(backend="cpu")`` and the port's
``H264Decoder(device="cpu")``, and every call must return the same
``(DecRet.name, consumed)``, every picture the same bytes, ``pic_id``,
``is_idr``, ``nbr_of_err_mbs``, size and ``crop``, and both must give the
same ``get_info`` and the same trace lines. Small pictures, CPU only,
every comparison exact."""

import dataclasses

import pytest
import torch

from broadway_tpu import api as ref_api
from broadway_tpu_torch import api as port_api
from broadway_tpu_torch.bitstream import bitreader as br
from broadway_tpu_torch.tools import streams

STREAMS = {
    "inter": lambda: streams.inter_stream(
        width_mbs=5, height_mbs=4, n_frames=4, seed=904, deblock=True)[0],
    "intra_mixed": lambda: streams.intra_mixed_stream(
        width_mbs=5, height_mbs=4, seed=903, deblock=True)[0],
    "multislice": lambda: streams.multislice_stream(
        width_mbs=4, height_mbs=3, seed=926, deblock_idc=2, alpha_off=6,
        beta_off=-6)[0],
    "poc_reorder": lambda: streams.poc_reorder_stream(
        poc_type=0, width_mbs=4, height_mbs=3)[0],
    "cropped": lambda: streams.cropped_stream()[0],
    "resolution_change": lambda: streams.inter_stream(
        width_mbs=4, height_mbs=3, n_frames=2, seed=61, deblock=True)[0]
    + streams.inter_stream(width_mbs=6, height_mbs=5, n_frames=2, seed=62,
                           deblock=True)[0],
}
MODES = ["whole", "chunks", "packets", "nal_units"]


def _rewrite_nals(data, index, keep_frac=None):
    """Drop NAL `index` (keep_frac None) or cut it to keep_frac."""
    out = bytearray()
    for i, (_, payload) in enumerate(br.split_nal_units(data)):
        if i == index:
            if keep_frac is None:
                continue
            payload = payload[:max(4, int(len(payload) * keep_frac))]
        out += b"\x00\x00\x00\x01" + payload
    return bytes(out)


def _drive(data, mode, make, **decode_kw):
    """Feed `data` to make() in `mode`; returns (calls, pictures, info,
    trace lines) in plain comparable values."""
    trace = []
    dec = make(trace=trace.append, streaming=(mode == "chunks"))
    calls, pics = [], []

    def take(flush=False):
        while True:
            p = dec.next_picture(flush=flush)
            if p is None:
                return
            pics.append((p.output_picture, p.pic_id, p.is_idr,
                         p.nbr_of_err_mbs, p.width, p.height, p.crop))

    if mode in ("whole", "chunks"):
        pieces = [data] if mode == "whole" else \
            [data[i:i + 257] for i in range(0, len(data), 257)]
        for k, piece in enumerate(pieces):
            buf = piece
            while buf:
                ret, used = dec.decode(buf, pic_id=k, **decode_kw)
                calls.append((ret.name, used))
                take()
                if used <= 0:
                    break
                buf = buf[used:]
    else:
        for k, (_, payload) in enumerate(br.split_nal_units(data)):
            nal_mode = mode == "nal_units"
            ret, used = dec.decode(
                payload if nal_mode else b"\x00\x00\x00\x01" + payload,
                pic_id=k, nal_unit_stream=nal_mode, **decode_kw)
            calls.append((ret.name, used))
            take()
    take(flush=True)
    info = dec.get_info()
    dec.release()
    return calls, pics, dataclasses.asdict(info) if info else None, trace


def _both(data, mode, **decode_kw):
    want = _drive(data, mode,
                  lambda **kw: ref_api.H264Decoder(backend="cpu", **kw),
                  **decode_kw)
    got = _drive(data, mode,
                 lambda **kw: port_api.H264Decoder(device="cpu", **kw),
                 **decode_kw)
    assert got[0] == want[0]                    # (DecRet.name, consumed)
    assert len(got[1]) == len(want[1]) and want[1]
    for g, w in zip(got[1], want[1]):
        assert g[1:] == w[1:]                   # ids, flags, size, crop
        assert g[0] == w[0]                     # bytes
    assert got[2] == want[2] and want[2] is not None
    assert got[3] == want[3] and want[3]        # trace lines
    return got


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", sorted(STREAMS))
def test_api_equals_jax_package(name, mode):
    calls, pics, info, _ = _both(STREAMS[name](), mode)
    names = {c[0] for c in calls}
    assert names & {"PIC_RDY", "PIC_RDY_BUFF_NOT_EMPTY", "STRM_PROCESSED"}
    if name == "cropped":
        assert info["cropping_flag"] and pics[0][6] == info["crop_params"]
    if name == "resolution_change":
        assert {(p[4], p[5]) for p in pics} == {(64, 48), (96, 80)}


@pytest.mark.parametrize("from_ref", [False, True],
                         ids=["gray", "from_ref"])
@pytest.mark.parametrize("case", ["dropped_slice", "cut_slice"])
def test_api_concealment_equals_jax_package(case, from_ref):
    """A lost and a cut slice in an IDR picture of a multi-slice stream:
    the same concealed MB counts and bytes, under both settings of the
    per-call ``intra_conceal_from_ref``."""
    data = streams.multislice_stream(width_mbs=4, height_mbs=3, seed=926,
                                     deblock_idc=2, alpha_off=6,
                                     beta_off=-6)[0]
    nals = list(br.split_nal_units(data))
    # the second picture's second slice (SPS, PPS, then the slices)
    per_pic = (len(nals) - 2) // 4
    assert per_pic >= 2
    data = _rewrite_nals(data, 2 + per_pic + 1,
                         None if case == "dropped_slice" else 0.4)
    _, pics, _, _ = _both(data, "packets", intra_conceal_from_ref=from_ref)
    assert any(p[3] for p in pics)              # nbr_of_err_mbs


@pytest.mark.parametrize("limit", [1, 2, 3])
def test_evaluation_limit(limit):
    data = STREAMS["inter"]()
    logs = []
    for make in (lambda: ref_api.H264Decoder(backend="cpu",
                                             evaluation_limit=limit),
                 lambda: port_api.H264Decoder(device="cpu",
                                              evaluation_limit=limit)):
        dec = make()
        log, buf = [], data
        while buf:
            ret, used = dec.decode(buf)
            log.append((ret.name, used))
            if used <= 0:
                break
            buf = buf[used:]
        dec.release()
        logs.append(log)
    assert logs[0] == logs[1]
    assert logs[1][-1] == ("EVALUATION_LIMIT_EXCEEDED", 0)
    assert sum(c[0].startswith("PIC_RDY") for c in logs[1]) == limit


def test_enums_and_records_match():
    assert {m.name: m.value for m in port_api.DecRet} == \
        {m.name: m.value for m in ref_api.DecRet}
    assert port_api.H264Decoder.API_VERSION == ref_api.H264Decoder.API_VERSION
    assert [f.name for f in dataclasses.fields(port_api.DecInfo)] == \
        [f.name for f in dataclasses.fields(ref_api.DecInfo)]
    assert [f.name for f in dataclasses.fields(port_api.DecInput)] == \
        [f.name for f in dataclasses.fields(ref_api.DecInput)]


def test_empty_input_and_info_before_headers():
    for dec in (ref_api.H264Decoder(backend="cpu"),
                port_api.H264Decoder(device="cpu")):
        assert dec.get_info() is None
        ret, used = dec.decode(b"")
        assert (ret.name, used) == ("PARAM_ERR", 0)
        assert dec.next_picture() is None
        dec.release()
        dec.release()                          # idempotent


def test_pictures_stay_on_the_device_until_read():
    """next_picture hands out the frame; its bytes are fetched only when
    output_picture (or a host plane) is read."""
    dec = port_api.H264Decoder(device="cpu")
    dec.decode(STREAMS["cropped"]())
    pic = dec.next_picture(flush=True)
    assert pic.frame._host is None
    assert isinstance(pic.frame.dev_y, torch.Tensor)
    data = pic.output_picture
    assert pic.frame._host is not None
    assert len(data) == pic.width * pic.height * 3 // 2
    dec.release()


def test_default_device_is_the_card(monkeypatch):
    """Without an argument the API decodes on the card, with the slice
    pool of 8, and raises when there is none; the CPU is on request."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            port_api.H264Decoder()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    dec = port_api.H264Decoder()
    try:
        assert dec._core.device.type == "cuda"
        assert dec._core.parallel_slices == 8
    finally:
        dec.release()
    dec = port_api.H264Decoder(device="cpu")
    assert dec._core.device.type == "cpu" and dec._core.parallel_slices == 0
    dec.release()
    with pytest.raises(TypeError):
        port_api.H264Decoder(backend="cpu")

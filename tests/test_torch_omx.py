"""The port's OMX-style component (``broadway_tpu_torch/omx.py``) held
against the JAX package's (``broadway_tpu/omx.py``): the same input
buffers through both ``SoftAvc``s give the same events in the same
order, the same output buffers (bytes, size, crop, ``pic_id``) and the
same EOS flags. Small pictures, CPU only, every comparison exact."""

import pytest

from broadway_tpu import omx as ref_omx
from broadway_tpu_torch import omx as port_omx
from broadway_tpu_torch.core.recon import TorchFrame
from broadway_tpu_torch.tools import streams


def _resolution_change():
    return streams.inter_stream(width_mbs=4, height_mbs=3, n_frames=3,
                                seed=61, deblock=True)[0] + \
        streams.inter_stream(width_mbs=6, height_mbs=5, n_frames=3,
                             seed=62, deblock=True)[0]


STREAMS = {
    "resolution_change": _resolution_change,
    "cropped": lambda: streams.cropped_stream()[0],
    "poc_reorder": lambda: streams.poc_reorder_stream(
        poc_type=0, width_mbs=4, height_mbs=3)[0],
}


def _run(make, data, chunk):
    """The client loop of an OMX user: queue input in `chunk`-byte
    buffers (EOS on the last), acknowledge port-settings changes, dequeue
    until EOS. Returns (events, outputs) in plain comparable values."""
    events = []
    c = make(event_cb=lambda ev, args: events.append((ev.name, args)))
    outs = []

    def drain():
        while True:
            if c.output_port.enabled is False:
                c.reconfigure_output()
            o = c.dequeue_output()
            if o is None:
                return
            outs.append(o)

    pos = 0
    while pos < len(data):
        nxt = min(pos + chunk, len(data))
        if not c.queue_input(data[pos:nxt], eos=(nxt == len(data))):
            drain()              # the input port is full
            continue
        pos = nxt
    for _ in range(1000):
        drain()
        if c.eos_delivered and c.output_port.enabled:
            break
    assert c.eos_delivered
    ports = (_port(c.input_port), _port(c.output_port))
    return events, outs, ports


def _port(p):
    return (p.width, p.height, p.buffer_count, p.enabled)


def _plain(outs):
    return [(o.data, o.width, o.height, o.crop, o.pic_id, o.eos)
            for o in outs]


@pytest.mark.parametrize("chunk", [700, 64 * 1024])
@pytest.mark.parametrize("name", sorted(STREAMS))
def test_softavc_equals_jax_package(name, chunk):
    data = STREAMS[name]()
    want = _run(lambda **kw: ref_omx.SoftAvc(backend="cpu", **kw), data,
                chunk)
    got = _run(lambda **kw: port_omx.SoftAvc(device="cpu", **kw), data,
               chunk)
    assert got[0] == want[0] and want[0]                  # events
    assert _plain(got[1]) == _plain(want[1])              # buffers, EOS
    assert got[2] == want[2]                              # port definitions
    frames = [o for o in got[1] if o.data]
    assert frames and (got[1][-1].eos or frames[-1].eos)
    assert all(isinstance(o.frame, TorchFrame) for o in frames)
    if name == "resolution_change":
        assert [a for e, a in got[0] if e == "PORT_SETTINGS_CHANGED"] == \
            [(64, 48), (96, 80)]
        assert [o.width for o in frames] == [64] * 3 + [96] * 3
    if name == "cropped":
        assert ("CROP_CHANGED", ((4, 6, 2, 8),)) in got[0]


def test_output_gated_until_reconfigure():
    data = streams.inter_stream(width_mbs=4, height_mbs=3, n_frames=2,
                                seed=64, deblock=True)[0]
    for c in (ref_omx.SoftAvc(backend="cpu"),
              port_omx.SoftAvc(device="cpu")):
        c.queue_input(data, eos=True)
        # before the client acks the initial settings change, no output
        assert c.output_port.enabled is False
        assert c.dequeue_output() is None
        c.reconfigure_output()
        o = c.dequeue_output()
        assert o is not None and (o.width, o.height) == (64, 48)


def test_input_port_fills_up():
    """Nine buffers into an 8-deep port while the output is gated: both
    components refuse the same one."""
    data = streams.inter_stream(width_mbs=4, height_mbs=3, n_frames=2,
                                seed=64, deblock=True)[0]
    pieces = [data[i:i + 40] for i in range(0, 40 * 12, 40)]
    took = []
    for c in (ref_omx.SoftAvc(backend="cpu"),
              port_omx.SoftAvc(device="cpu")):
        took.append([c.queue_input(p) for p in pieces])
    assert took[0] == took[1]


def test_eos_with_nothing_pending():
    for c in (ref_omx.SoftAvc(backend="cpu"),
              port_omx.SoftAvc(device="cpu")):
        c.queue_input(b"\x00\x00\x00\x01\x09\x10", eos=True)   # an AUD only
        o = c.dequeue_output()
        assert o is not None and o.eos and o.data == b"" and o.pic_id == -1
        assert c.eos_delivered


def test_enums_match():
    assert {m.name: m.value for m in port_omx.Event} == \
        {m.name: m.value for m in ref_omx.Event}
    assert (port_omx.SoftAvc.NUM_INPUT_BUFFERS,
            port_omx.SoftAvc.NUM_OUTPUT_BUFFERS) == \
        (ref_omx.SoftAvc.NUM_INPUT_BUFFERS,
         ref_omx.SoftAvc.NUM_OUTPUT_BUFFERS)

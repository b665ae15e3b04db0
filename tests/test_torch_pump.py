"""The dispatch pump of the port (``Decoder(async_pump=True)``, the
counterpart of the JAX package's ``async_pump``): the upload and the
per-picture step of each v2 picture run on one worker thread in
submission order, and the frames are lazy until the pump drains.

On the CPU the step runs the kernels' plain versions: the pumped decoder
equals the un-pumped one and the JAX package's NumPy decoder byte for
byte, through multi-ref inter pictures, concealment, a resolution change,
a PPS change, a picture the v2 packer declines, a checkpoint taken while
jobs are queued, output prefetch and parallel slice parsing; a failed
step raises and is never dropped; ``close`` stops the worker; and the
default is the JAX package's (on for a "cuda" torch decoder without
frame groups or a recon_strategy). The launch counts stay exact with many
threads adding to them. The card's side is in tests/test_torch_kernels.py.
"""

import pickle
import sys
import threading
from concurrent import futures

import numpy as np
import pytest
import torch

from broadway_tpu.core.decoder import Decoder as BaseDecoder
from broadway_tpu_torch.api import H264Decoder
from broadway_tpu_torch.bitstream import bitreader as br
from broadway_tpu_torch.core import decoder as DEC
from broadway_tpu_torch.core import packed as PK
from broadway_tpu_torch.core import recon as RC
from broadway_tpu_torch.core.decoder import Decoder
from broadway_tpu_torch.ops.gpu import _build
from broadway_tpu_torch.tools import streams


def _frames(dec, data):
    try:
        return [o.frame.tobytes() for o in dec.decode_annexb(data)]
    finally:
        if isinstance(dec, Decoder):
            dec.close()


def _nals(data):
    return [br.NalUnit(p) for _, p in br.split_nal_units(data)]


def _truncate(data, index, keep_frac):
    """NAL `index` cut to keep_frac of its bytes (a corrupt slice)."""
    out = bytearray()
    for i, (_, payload) in enumerate(br.split_nal_units(data)):
        if i == index:
            payload = payload[:max(4, int(len(payload) * keep_frac))]
        out += b"\x00\x00\x00\x01" + payload
    return bytes(out)


def _pump_threads():
    """The live pump workers (the JAX package names its own the same, and
    a decoder of another test left open keeps one: compare sets)."""
    return {t for t in threading.enumerate() if t.name.startswith("bw-pump")}


SCENARIOS = {
    "multi_ref": lambda: streams.inter_stream(
        width_mbs=5, height_mbs=4, n_frames=6, seed=814, num_ref_frames=2,
        multi_ref_idx=True, deblock=True, mvd_range=80)[0],
    # a corrupt slice: the picture is concealed on the host after a drain
    "truncated": lambda: _truncate(streams.inter_stream(
        width_mbs=5, height_mbs=4, n_frames=6, seed=956, deblock=True)[0],
        4, 0.4),
    # a new size at an IDR, then the end of the stream
    "resolution_change": lambda: (
        streams.inter_stream(width_mbs=4, height_mbs=3, n_frames=3, seed=61,
                             deblock=True)[0]
        + streams.inter_stream(width_mbs=6, height_mbs=5, n_frames=3,
                               seed=62, deblock=True)[0]),
    "pps_change": lambda: b"".join(
        streams.multislice_stream(width_mbs=4, height_mbs=3, n_frames=3,
                                  seed=s, deblock_idc=0,
                                  chroma_qp_offset=c)[0]
        for s, c in ((71, 0), (72, 4), (73, -3))),
    "frame_num_gaps": lambda: streams.gaps_stream(width_mbs=4,
                                                  height_mbs=3)[0],
}

VARIANTS = {
    "plain": {},
    "prefetch": dict(prefetch_outputs=True),
    "slices4": dict(parallel_slices=4),
}


@pytest.fixture(scope="module")
def wanted():
    """scenario -> (stream, the JAX package's NumPy decoder's frames)."""
    out = {}
    for name, make in SCENARIOS.items():
        data = make()
        out[name] = (data, _frames(BaseDecoder(backend="cpu"), data))
    return out


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_pumped_equals_unpumped_and_jax(wanted, name, variant):
    data, want = wanted[name]
    kw = VARIANTS[variant]
    off = Decoder(device="cpu", **kw)
    assert not off.async_pump
    assert _frames(off, data) == want
    dec = Decoder(device="cpu", async_pump=True, **kw)
    outs = dec.decode_annexb(data)
    assert dec._pump_pend == []            # decode_annexb drained the pump
    assert any(isinstance(o.frame, RC.LazyTorchFrame) for o in outs)
    assert [o.frame.tobytes() for o in outs] == want
    dec.close()
    assert dec._pump is None


def test_truncated_stream_conceals_pumped(wanted):
    data, want = wanted["truncated"]
    dec = Decoder(device="cpu", async_pump=True)
    outs = dec.decode_annexb(data)
    dec.close()
    assert any(o.num_err_mbs for o in outs)
    assert [o.frame.tobytes() for o in outs] == want


def test_v2_declined_picture_runs_v1_after_the_drain(monkeypatch):
    """A picture that v2 declines takes v1 on the feed thread, which
    writes the stacks: every job queued before it has run first."""
    data = SCENARIOS["multi_ref"]()
    want = _frames(BaseDecoder(backend="cpu"), data)
    v2, v1, step = PK.pack_picture_v2, DEC.Decoder._v1_step, \
        DEC.decode_picture_packed2
    calls, order = [0], []

    def declining(*a, **k):
        calls[0] += 1
        return None if calls[0] == 3 else v2(*a, **k)

    def pumped(*a, **k):
        assert threading.current_thread().name.startswith("bw-pump")
        order.append("pump")
        return step(*a, **k)

    def v1_step(*a, **k):
        assert threading.current_thread() is threading.main_thread()
        order.append("v1")
        return v1(*a, **k)

    monkeypatch.setattr(PK, "pack_picture_v2", declining)
    monkeypatch.setattr(DEC, "decode_picture_packed2", pumped)
    monkeypatch.setattr(DEC.Decoder, "_v1_step", v1_step)
    assert _frames(Decoder(device="cpu", async_pump=True), data) == want
    assert order == ["pump", "pump", "v1", "pump", "pump", "pump"]


def test_save_and_load_state_with_jobs_queued():
    """save_state while the pump holds jobs drains it first: the snapshot
    equals the JAX package's decoder at the same point, and a pumped
    decoder resumed from it finishes the stream."""
    data = SCENARIOS["multi_ref"]()
    want = _frames(BaseDecoder(backend="cpu"), data)
    nals = _nals(data)
    gate = threading.Event()
    step = DEC.decode_picture_packed2

    def held(*a, **k):          # the jobs wait until the snapshot starts
        gate.wait(timeout=60)
        return step(*a, **k)

    port = Decoder(device="cpu", async_pump=True)
    ref = BaseDecoder()
    k = 0
    DEC.decode_picture_packed2 = held
    try:
        while port.pic_number < 3 or port.pic is not None:
            port.decode_nal(nals[k])
            ref.decode_nal(nals[k])
            k += 1
        assert len(port._pump_pend) >= 2       # queued, not yet run
        gate.set()
        st, st_ref = port.save_state(), ref.save_state()
    finally:
        DEC.decode_picture_packed2 = step
        gate.set()
    assert port._pump_pend == []
    for p, q in zip(st["dpb"]["buffer"], st_ref["dpb"]["buffer"]):
        assert (p["pic_id"], p["slot"], p["poc"]) == \
            (q["pic_id"], q["slot"], q["poc"])
        assert (p["planes"] is None) == (q["planes"] is None)
        if p["planes"] is not None:
            assert all(np.array_equal(a, b)
                       for a, b in zip(p["planes"], q["planes"]))
    resumed = Decoder(device="cpu", async_pump=True)
    resumed.load_state(pickle.loads(pickle.dumps(st)))
    for nal in nals[k:]:
        resumed.decode_nal(nal)
    resumed.flush()
    assert [o.frame.tobytes() for o in port.outputs + resumed.outputs] == \
        want
    port.close()
    resumed.close()


def test_lazy_frame_read_while_its_job_is_queued():
    """A frame read before its job ran drains the pump and gets its bytes;
    a start_fetch before then is remembered."""
    data = SCENARIOS["multi_ref"]()
    want = _frames(BaseDecoder(backend="cpu"), data)
    gate = threading.Event()
    step = DEC.decode_picture_packed2

    def held(*a, **k):
        gate.wait(timeout=60)
        return step(*a, **k)

    dec = Decoder(device="cpu", async_pump=True)
    nals = _nals(data)
    k = 0
    DEC.decode_picture_packed2 = held
    try:
        while dec.pic_number < 1 or dec.pic is not None:
            dec.decode_nal(nals[k])
            k += 1
        first = dec.dpb.buffer[0].frame
        assert isinstance(first, RC.LazyTorchFrame) and first._frame is None
        first.start_fetch()
        assert first._frame is None and first._want_fetch
        gate.set()
        assert first.tobytes() == want[0]
    finally:
        DEC.decode_picture_packed2 = step
        gate.set()
    for nal in nals[k:]:
        dec.decode_nal(nal)
    dec.flush()
    dec.close()
    assert [o.frame.tobytes() for o in dec.outputs] == want


def _failing_step(monkeypatch, fail_at: int):
    """The per-picture step raises on picture `fail_at` (1-based)."""
    step, calls = DEC.decode_picture_packed2, [0]

    def failing(*a, **k):
        calls[0] += 1
        if calls[0] == fail_at:
            raise RuntimeError("step failed on purpose")
        return step(*a, **k)

    monkeypatch.setattr(DEC, "decode_picture_packed2", failing)
    return calls


def test_failed_job_raises_at_the_next_decode_call(monkeypatch):
    data = SCENARIOS["multi_ref"]()
    _failing_step(monkeypatch, 2)
    before = _pump_threads()
    dec = Decoder(device="cpu", async_pump=True, no_reordering=True)
    nals = _nals(data)
    k = 0
    while dec.pic_number < 2 or dec.pic is not None:
        dec.decode_nal(nals[k])
        k += 1
    futures.wait(dec._pump_pend, timeout=60)     # picture 2's job is done
    frames = [o.frame for o in dec.outputs]
    assert len(frames) == 2
    with pytest.raises(RuntimeError, match="step failed on purpose"):
        for nal in nals[k:]:                     # picture 3's submit
            dec.decode_nal(nal)
    assert dec.pic_number == 2                   # picture 3's submit raised
    assert frames[0].tobytes()                   # decoded before the fault
    with pytest.raises(RuntimeError, match="not decoded") as err:
        frames[1].tobytes()
    assert "on purpose" in str(err.value.__cause__)
    with pytest.raises(RuntimeError, match="on purpose"):
        dec.flush()                              # and again: never dropped
    with pytest.raises(RuntimeError, match="on purpose"):
        dec.close()
    assert dec._pump is None and _pump_threads() <= before


def test_failed_job_raises_from_decode_annexb_and_on_access(monkeypatch):
    """However the jobs and the feed thread interleave, a failure reaches
    the caller by the end of decode_annexb, and the frames queued behind
    the failed one raise too instead of holding stale pictures."""
    data = SCENARIOS["multi_ref"]()
    _failing_step(monkeypatch, 2)
    before = _pump_threads()
    dec = Decoder(device="cpu", async_pump=True, no_reordering=True)
    with pytest.raises(RuntimeError, match="step failed on purpose"):
        dec.decode_annexb(data)
    frames = [p.frame for p in dec.dpb.buffer if p.frame is not None] + \
        [o.frame for o in dec.outputs]
    bad = [f for f in frames
           if isinstance(f, RC.LazyTorchFrame) and f._error is not None]
    assert bad
    for f in bad:
        with pytest.raises(RuntimeError, match="not decoded"):
            f.y
    with pytest.raises(RuntimeError, match="on purpose"):
        dec.close()
    assert _pump_threads() <= before


def test_close_leaves_no_pump_thread():
    data = SCENARIOS["multi_ref"]()
    before = _pump_threads()
    decs = [Decoder(device="cpu", async_pump=True) for _ in range(3)]
    for d in decs:
        d.decode_annexb(data)
    assert len(_pump_threads() - before) == 3
    for d in decs:
        d.close()
    assert _pump_threads() <= before
    assert all(d._pump is None for d in decs)


def test_defaults_and_refusals(monkeypatch):
    assert not Decoder(device="cpu").async_pump
    assert not Decoder(device="cpu", recon="numpy").async_pump
    with pytest.raises(ValueError, match="frame groups"):
        Decoder(device="cpu", async_pump=True, group_frames=2)
    with pytest.raises(ValueError, match="recon='torch'"):
        Decoder(device="cpu", async_pump=True, recon="numpy")
    with pytest.raises(ValueError, match="recon_strategy"):
        Decoder(device="cpu", async_pump=True, recon_strategy=lambda d, p:
                None)
    assert Decoder(device="cpu", async_pump=True, group_frames=1).async_pump
    # on the card (only the constructor runs: it touches no device)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert Decoder(device="cuda").async_pump
    assert Decoder(device="cuda", group_frames=1).async_pump
    assert not Decoder(device="cuda", group_frames=2).async_pump
    assert not Decoder(device="cuda", async_pump=False).async_pump
    assert not Decoder(device="cuda", recon="numpy").async_pump
    assert not Decoder(device="cuda",
                       recon_strategy=lambda d, p: None).async_pump
    # the entry points take the decoder's default
    assert H264Decoder(device="cuda")._core.async_pump
    assert not H264Decoder(device="cpu")._core.async_pump


def test_strategy_decoders_never_pump(monkeypatch):
    """The lockstep and band paths build their decoders with a
    recon_strategy, so they never pump (and they decline pictures to the
    per-picture step on the feed thread)."""
    from broadway_tpu_torch.parallel.slices import decode_stream_sliced
    from broadway_tpu_torch.parallel.streams import decode_streams_lockstep

    made = []
    init = Decoder.__init__

    def spy(self, *a, **k):
        init(self, *a, **k)
        made.append(self)

    monkeypatch.setattr(Decoder, "__init__", spy)
    data = SCENARIOS["multi_ref"]()
    want = _frames(BaseDecoder(backend="cpu"), data)
    assert decode_streams_lockstep([data, data], device="cpu") == \
        [want, want]
    assert decode_stream_sliced(data, ["cpu", "cpu"], 2) == want
    assert made and all(d.recon_strategy is not None and not d.async_pump
                        and d._pump is None for d in made)


def test_pumped_equals_the_jax_pumped_path():
    """The JAX package's own pump (backend="tpu", on by default there; XLA
    on the CPU): the same frames, in the same order, with the same ids."""
    pytest.importorskip("jax")
    data = streams.inter_stream(width_mbs=3, height_mbs=2, n_frames=4,
                                seed=815, deblock=True)[0]
    base = BaseDecoder(backend="tpu")
    assert base.async_pump
    want = base.decode_annexb(data)
    base.close()
    dec = Decoder(device="cpu", async_pump=True)
    got = dec.decode_annexb(data)
    dec.close()
    assert [(o.pic_id, o.is_idr, o.frame.tobytes()) for o in got] == \
        [(o.pic_id, o.is_idr, o.frame.tobytes()) for o in want]


def test_pumped_decoders_on_threads_equal_sequential():
    """Four pumped decoders fed from four threads at once (eight threads in
    all with their workers) give what each gives alone."""
    datas = [streams.inter_stream(width_mbs=4, height_mbs=3, n_frames=4,
                                  seed=s, deblock=True, mvd_range=60)[0]
             for s in (31, 32, 33, 34)]
    wants = [_frames(Decoder(device="cpu"), d) for d in datas]
    gots, errors = [None] * 4, []
    before = _pump_threads()

    def run(i):
        try:
            gots[i] = _frames(Decoder(device="cpu", async_pump=True),
                              datas[i])
        except Exception as e:       # re-raised below, on the test's thread
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert gots == wants
    assert _pump_threads() <= before


def test_launch_counts_are_exact_across_threads():
    """count_launch from 16 threads, with the interpreter switching threads
    as often as it can: no increment is lost."""
    def wrapper():
        pass
    wrapper.launches = 0
    n_threads, n_each = 16, 5000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [_build.count_launch(wrapper)
                            for _ in range(n_each)])
            for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert wrapper.launches == n_threads * n_each

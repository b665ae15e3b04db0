"""The port's three hand-written CUDA kernels against their plain torch
versions, on the card (marker ``cuda``; without a card every test here
skips). Inputs come from real packed pictures of small streams, made
from fixed seeds, and for the persistent wavefront kernels also from
synthetic operands at chosen geometries; comparisons are byte equality.
The kernels' tests need nothing of the JAX package; the whole-decoder
test takes that package's NumPy decoder (which imports no JAX) as its
reference, so that the port is not held against itself. Run on a CUDA
host:

    python -m pytest tests/test_torch_kernels.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from broadway_tpu_torch.core.decoder import Decoder
from broadway_tpu_torch.core.packed import pack_stream, unpack_arrs_v2
from broadway_tpu_torch.core.recon import decode_picture
from broadway_tpu_torch.ops.gpu import deblock, inter, intra
from broadway_tpu_torch.ops.gpu import mc_kernel as K1
from broadway_tpu_torch.ops.gpu import probe
from broadway_tpu_torch.ops.gpu import wavefront_kernels as KW
from broadway_tpu_torch.ops.gpu.residual import residual_stage
from broadway_tpu_torch.tools import streams, synth

pytestmark = pytest.mark.cuda

STREAMS = {
    "intra_mixed": lambda: streams.intra_mixed_stream(
        width_mbs=6, height_mbs=5, n_frames=2, seed=812, deblock=True)[0],
    "wild_mv_multi_ref": lambda: streams.inter_stream(
        width_mbs=11, height_mbs=7, n_frames=4, seed=20260821, deblock=True,
        mvd_range=400, num_ref_frames=2, multi_ref_idx=True)[0],
    "multislice_idc2": lambda: streams.multislice_stream(
        width_mbs=6, height_mbs=5, seed=926, deblock_idc=2, alpha_off=6,
        beta_off=-6, chroma_qp_offset=2)[0],
    "realistic": lambda: streams.realistic_stream(
        width_mbs=12, height_mbs=8, n_frames=3, n_slices=3, seed=5)[0],
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _inputs(name, dev):
    """(arrs, w, h, chroma offset, random ref stacks) per picture."""
    rng = np.random.RandomState(7)
    for buf, bk, lay, ci, co, R in pack_stream(STREAMS[name]()):
        arrs = unpack_arrs_v2(torch.from_numpy(buf).to(dev), lay, bk, ci, co)
        ref_y = torch.from_numpy(rng.randint(
            0, 256, (R, 16 * lay.h, 16 * lay.w), dtype=np.uint8)).to(dev)
        ref_c = torch.from_numpy(rng.randint(
            0, 256, (R, 2, 8 * lay.h, 8 * lay.w), dtype=np.uint8)).to(dev)
        yield arrs, lay.w, lay.h, co, ref_y, ref_c


def _check_k1(ref_y, ref_c, mv, rb, w, h):
    """K1 against its plain version (all bytes); blocks with ref_blk < 0
    read 0."""
    n0 = K1.mc_predict.launches
    got = K1.mc_predict(ref_y, ref_c, mv, rb, w, h)
    want = inter.mc_predict_plain(ref_y, ref_c, mv, rb, w, h)
    torch.cuda.synchronize()
    assert K1.mc_predict.launches == n0 + 1
    assert got[0].dtype == got[1].dtype == torch.uint8
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    used = rb >= 0
    uy = used.repeat_interleave(4, 1).repeat_interleave(4, 2)
    uc = used.repeat_interleave(2, 1).repeat_interleave(4, 2)
    assert not got[0][~uy].any() and not got[1][~uc].any()


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_k1_mc_equals_plain(cuda, name):
    for arrs, w, h, _, ref_y, ref_c in _inputs(name, cuda):
        _check_k1(ref_y, ref_c, arrs["mv"].contiguous(),
                  arrs["ref_blk"].contiguous(), w, h)


@pytest.mark.parametrize("case", synth.MC_CASES)
def test_k1_mc_case_equals_plain(cuda, case):
    """The cases of tests/test_torch_mc.py (mixed intra/inter MBs, 16
    vectors per MB, every fraction, every edge and corner), here for the
    kernel; 11x7 MBs so that edge cases meet odd and even MBs."""
    w, h, R = 11, 7, 3
    rng = np.random.RandomState(len(case))
    mv, rb = (torch.from_numpy(a).to(cuda)
              for a in synth.mc_operands(case, w, h, R))
    ref_y = torch.from_numpy(rng.randint(
        0, 256, (R, 16 * h, 16 * w), dtype=np.uint8)).to(cuda)
    ref_c = torch.from_numpy(rng.randint(
        0, 256, (R, 2, 8 * h, 8 * w), dtype=np.uint8)).to(cuda)
    _check_k1(ref_y, ref_c, mv, rb, w, h)


def test_k1_all_intra_picture_is_zero(cuda):
    """No block predicts: every CTA leaves after reading ref_blk, and the
    outputs (allocated uninitialised) are 0 all the same."""
    w, h, R = 9, 5, 2
    n = w * h
    ref_y = torch.full((R, 16 * h, 16 * w), 200, dtype=torch.uint8,
                       device=cuda)
    ref_c = torch.full((R, 2, 8 * h, 8 * w), 200, dtype=torch.uint8,
                       device=cuda)
    mv = torch.full((n, 4, 4, 2), 7, dtype=torch.int32, device=cuda)
    rb = torch.full((n, 4, 4), -1, dtype=torch.int32, device=cuda)
    torch.full((n, 16, 16), 99, dtype=torch.uint8, device=cuda)  # dirty pool
    _check_k1(ref_y, ref_c, mv, rb, w, h)


def test_k1_launch_probe_runs(cuda):
    ctas, threads = K1.launch_shape(8160)
    assert ctas * (threads // 32) >= 8160     # a warp per MB
    probe.launch_probe(ctas, threads, cuda)
    torch.cuda.synchronize()


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_k2_intra_equals_plain(cuda, name):
    for arrs, w, h, co, ref_y, ref_c in _inputs(name, cuda):
        Y0, C0 = decode_picture(arrs, ref_y, ref_c, w, h, co, run_stages=1)
        RY, RC = residual_stage(arrs, co)
        P = intra.intra_params(arrs)
        Yk, Ck, Yp, Cp = Y0.clone(), C0.clone(), Y0.clone(), C0.clone()
        KW.intra_wavefront(Yk, Ck, RY, RC, P, w, h)
        intra.intra_wavefront_plain(Yp, Cp, RY, RC, P, w, h)
        torch.cuda.synchronize()
        assert torch.equal(Yk, Yp) and torch.equal(Ck, Cp)


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_k3_deblock_equals_plain(cuda, name):
    for arrs, w, h, co, ref_y, ref_c in _inputs(name, cuda):
        Y0, C0 = decode_picture(arrs, ref_y, ref_c, w, h, co, run_stages=2)
        P = deblock.deblock_params(arrs, w, h)
        Yk, Ck, Yp, Cp = Y0.clone(), C0.clone(), Y0.clone(), C0.clone()
        KW.deblock_wavefront(Yk, Ck, P, w, h)
        deblock.deblock_wavefront_plain(Yp, Cp, P, w, h)
        torch.cuda.synchronize()
        assert torch.equal(Yk, Yp) and torch.equal(Ck, Cp)


def test_wrappers_check_cuda_inputs(cuda):
    w, h = 2, 2
    Y = torch.zeros((32, 32), dtype=torch.uint8, device=cuda)
    C = torch.zeros((2, 16, 16), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError):        # int32 params expected
        KW.deblock_wavefront(Y, C, torch.zeros((4, 64), device=cuda), w, h)
    with pytest.raises(ValueError):        # planes must be contiguous
        KW.deblock_wavefront(Y.t(), C, torch.zeros(
            (4, 64), dtype=torch.int32, device=cuda), w, h)


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_cuda_decoder_equals_numpy(cuda, name):
    # the reference side only: the JAX package's NumPy decoder
    from broadway_tpu.core.decoder import Decoder as BaseDecoder
    data = STREAMS[name]()
    want = [o.frame.tobytes()
            for o in BaseDecoder(backend="cpu").decode_annexb(data)]
    got = [o.frame.tobytes()
           for o in Decoder(device="cuda").decode_annexb(data)]
    assert want and got == want
    # the port's own NumPy path, which chip_smoke.py takes as reference
    own = [o.frame.tobytes() for o in
           Decoder(device="cpu", recon="numpy").decode_annexb(data)]
    assert own == want


# ---------------------------------------------------------------------------
# the persistent wavefront kernels (one launch per picture) on synthetic
# operands: edge geometries, every kind of picture, the row stride
# ---------------------------------------------------------------------------

# heights around the cluster edges (C = KW.CLUSTER = 8 rows a cluster):
# C - 1, C, C + 1, 2C + 1 and 2C + 2 rows (a 1080p band of 17 rows with
# its ghost row: a partial last cluster of 2), and the 4K picture's odd
# 135 rows
GEOMETRIES = [(1, 1), (1, 7), (9, 1), (3, 2), (120, 68), (4, 7), (7, 8),
              (6, 9), (5, 17), (120, 18), (240, 135)]


def _t(a, dev):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def _run_intra(dev, w, h, kind, seed, runs=1):
    Y0, C0 = (_t(a, dev) for a in synth.planes(w, h, seed))
    RY, RC, P = (_t(a, dev) for a in synth.intra_operands(w, h, seed + 1,
                                                          kind))
    Yp, Cp = Y0.clone(), C0.clone()
    intra.intra_wavefront_plain(Yp, Cp, RY, RC, P, w, h)
    for _ in range(runs):
        Yk, Ck = Y0.clone(), C0.clone()
        KW.intra_wavefront(Yk, Ck, RY, RC, P, w, h)
        torch.cuda.synchronize()
        assert torch.equal(Yk, Yp) and torch.equal(Ck, Cp)


def _run_deblock(dev, w, h, kind, seed, runs=1):
    Y0, C0 = (_t(a, dev) for a in synth.planes(w, h, seed, smooth=True))
    P = _t(synth.deblock_operands(w, h, seed + 1, kind), dev)
    Yp, Cp = Y0.clone(), C0.clone()
    deblock.deblock_wavefront_plain(Yp, Cp, P, w, h)
    if kind == "intra" and w * h > 1:
        assert not torch.equal(Yp, Y0)       # the filter did fire
    for _ in range(runs):
        Yk, Ck = Y0.clone(), C0.clone()
        KW.deblock_wavefront(Yk, Ck, P, w, h)
        torch.cuda.synchronize()
        assert torch.equal(Yk, Yp) and torch.equal(Ck, Cp)


@pytest.mark.parametrize("kind", synth.KINDS)
@pytest.mark.parametrize("geom", GEOMETRIES, ids=lambda g: f"{g[0]}x{g[1]}")
def test_k2_persistent_geometries(cuda, geom, kind):
    _run_intra(cuda, geom[0], geom[1], kind, seed=100 + geom[0])


@pytest.mark.parametrize("kind", synth.KINDS)
@pytest.mark.parametrize("geom", GEOMETRIES, ids=lambda g: f"{g[0]}x{g[1]}")
def test_k3_persistent_geometries(cuda, geom, kind):
    _run_deblock(cuda, geom[0], geom[1], kind, seed=200 + geom[0])


@pytest.mark.parametrize("kind", synth.KINDS)
@pytest.mark.parametrize("kernel", ["K2", "K3"])
def test_more_rows_than_resident_ctas(cuda, kernel, kind):
    """23 rows (3 row blocks of 8) on a grid capped at 2 clusters: cluster
    k takes row blocks k, k + 2, ... in increasing order, and the ring of
    a CTA is used again for its next row; it must neither deadlock nor
    differ. A cap of 20 CTAs is 2 whole clusters."""
    run, which = {"K2": (_run_intra, KW.INTRA),
                  "K3": (_run_deblock, KW.DEBLOCK)}[kernel]
    old = KW.set_max_ctas(20)
    try:
        run(cuda, 17, 23, kind, seed=300)
        assert KW.last_grid(which) == 16
        assert KW.last_cluster(which) == KW.CLUSTER
    finally:
        KW.set_max_ctas(old)
    run(cuda, 17, 23, kind, seed=300)
    assert KW.last_grid(which) == 24


@pytest.mark.parametrize("kernel", ["K2", "K3"])
def test_twice_on_the_same_workspace(cuda, kernel):
    """Stale progress counters would let the second run read neighbours
    before they are written: it passes once and fails twice."""
    run = {"K2": _run_intra, "K3": _run_deblock}[kernel]
    run(cuda, 40, 30, "intra", seed=400, runs=3)
    run(cuda, 40, 30, "mixed", seed=401, runs=3)


def test_one_device_launch_per_picture(cuda):
    w, h = 20, 12
    KW.device_launches(KW.INTRA, reset=True)
    KW.device_launches(KW.DEBLOCK, reset=True)
    _run_intra(cuda, w, h, "intra", seed=500)
    _run_deblock(cuda, w, h, "intra", seed=501)
    assert KW.device_launches(KW.INTRA) == 1
    assert KW.device_launches(KW.DEBLOCK) == 1


def test_handoff_probe_runs(cuda):
    """The probe at the cluster size K2 / K3 take, with every hand-off
    across clusters (C = 1), and at the card's non-portable 16."""
    KW.device_launches(KW.PROBE, reset=True)
    for c in (KW.CLUSTER, 1, 16):
        KW.handoff_probe(120, 68, cuda, cluster=c)
        torch.cuda.synchronize()
        assert KW.last_cluster(KW.PROBE) == c
        assert KW.last_grid(KW.PROBE) % c == 0
    assert KW.device_launches(KW.PROBE) == 3


# ---------------------------------------------------------------------------
# a batch of pictures (the streams of one lockstep round) in ONE launch per
# kernel: against the plain versions, and against one launch per picture
# ---------------------------------------------------------------------------

BATCHES = [1, 2, 3, 8]
KIND_CYCLE = ("intra", "mixed", "idle")    # IDR-like, P-like, nothing to do


def _mc_batch(dev, B, w, h, R, seed=0):
    """B pictures' K1 operands (a different named case each) and their
    stacks [B*R, ...]."""
    rng = np.random.RandomState(1000 + seed)
    cases = [synth.MC_CASES[(7 * b + seed) % len(synth.MC_CASES)]
             for b in range(B)]
    ops = [synth.mc_operands(c, w, h, R) for c in cases]
    mv = _t(np.concatenate([o[0] for o in ops]), dev)
    rb = _t(np.concatenate([o[1] for o in ops]), dev)
    ref_y = _t(rng.randint(0, 256, (B * R, 16 * h, 16 * w), dtype=np.uint8),
               dev)
    ref_c = _t(rng.randint(0, 256, (B * R, 2, 8 * h, 8 * w), dtype=np.uint8),
               dev)
    return ref_y, ref_c, mv, rb


@pytest.mark.parametrize("B", BATCHES)
def test_k1_batched_equals_plain_and_single_launches(cuda, B):
    w, h, R = 11, 7, 3
    n = w * h
    ref_y, ref_c, mv, rb = _mc_batch(cuda, B, w, h, R)
    n0 = K1.mc_predict.launches
    got = K1.mc_predict(ref_y, ref_c, mv, rb, w, h)
    assert K1.mc_predict.launches == n0 + 1          # one launch for all
    want = inter.mc_predict_plain(ref_y, ref_c, mv, rb, w, h)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for b in range(B):
        one = K1.mc_predict(ref_y[b * R:(b + 1) * R].contiguous(),
                            ref_c[b * R:(b + 1) * R].contiguous(),
                            mv[b * n:(b + 1) * n], rb[b * n:(b + 1) * n], w, h)
        assert torch.equal(one[0], got[0][b * n:(b + 1) * n])
        assert torch.equal(one[1], got[1][b * n:(b + 1) * n])


def test_k1_subset_of_streams_through_stack_base(cuda):
    """Two of four streams take part: the table names their stacks where
    they lie among all four, in the round's order."""
    w, h, R, A = 6, 5, 3, 4
    n = w * h
    ref_y, ref_c, _, _ = _mc_batch(cuda, A, w, h, R, seed=1)
    _, _, mv, rb = _mc_batch(cuda, 2, w, h, R, seed=2)
    sub = [3, 1]
    base = torch.tensor([i * R for i in sub], dtype=torch.int32, device=cuda)
    got = K1.mc_predict(ref_y, ref_c, mv, rb, w, h, base, R)
    want = inter.mc_predict_plain(ref_y, ref_c, mv, rb, w, h, base, R)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for b, i in enumerate(sub):
        one = K1.mc_predict(ref_y[i * R:(i + 1) * R].contiguous(),
                            ref_c[i * R:(i + 1) * R].contiguous(),
                            mv[b * n:(b + 1) * n], rb[b * n:(b + 1) * n], w, h)
        assert torch.equal(one[0], got[0][b * n:(b + 1) * n])
        assert torch.equal(one[1], got[1][b * n:(b + 1) * n])
    with pytest.raises(ValueError):        # a table needs n_ref
        K1.mc_predict(ref_y, ref_c, mv, rb, w, h, base)
    with pytest.raises(ValueError):        # one entry per picture
        K1.mc_predict(ref_y, ref_c, mv, rb, w, h, base[:1].contiguous(), R)


def _wave_batch(dev, kernel, B, w, h, seed):
    """B pictures' planes and K2 or K3 operands, a different kind and
    seed each; returns (Y [B,H,W], C [B,2,H/2,W/2], operand tuple)."""
    Ys, Cs, ops = [], [], []
    for b in range(B):
        kind = KIND_CYCLE[(b + seed) % 3]
        Y, C = synth.planes(w, h, seed + 10 * b, smooth=kernel == "K3")
        Ys.append(Y)
        Cs.append(C)
        ops.append(synth.intra_operands(w, h, seed + 10 * b + 1, kind)
                   if kernel == "K2" else
                   (synth.deblock_operands(w, h, seed + 10 * b + 1, kind),))
    return (_t(np.stack(Ys), dev), _t(np.stack(Cs), dev),
            tuple(_t(np.concatenate([o[k] for o in ops]), dev)
                  for k in range(len(ops[0]))))


def _launch(kernel, Y, C, ops, w, h, **kw):
    if kernel == "K2":
        KW.intra_wavefront(Y, C, *ops, w, h)
    else:
        KW.deblock_wavefront(Y, C, *ops, w, h, **kw)


def _plain(kernel, Y, C, ops, w, h, **kw):
    if kernel == "K2":
        intra.intra_wavefront_plain(Y, C, *ops, w, h)
    else:
        deblock.deblock_wavefront_plain(Y, C, *ops, w, h, **kw)


def _check_wave_batch(dev, kernel, B, w, h, seed, singles=True):
    n = w * h
    Y0, C0, ops = _wave_batch(dev, kernel, B, w, h, seed)
    Yk, Ck, Yp, Cp = Y0.clone(), C0.clone(), Y0.clone(), C0.clone()
    which = KW.INTRA if kernel == "K2" else KW.DEBLOCK
    KW.device_launches(which, reset=True)
    _launch(kernel, Yk, Ck, ops, w, h)
    torch.cuda.synchronize()
    assert KW.device_launches(which) == 1          # one launch for all
    _plain(kernel, Yp, Cp, ops, w, h)
    assert torch.equal(Yk, Yp) and torch.equal(Ck, Cp)
    if kernel == "K3" and B >= 1 and w * h > 1:
        assert not torch.equal(Yk, Y0)             # something was filtered
    if singles:
        for b in range(B):
            Y1, C1 = Y0[b].clone(), C0[b].clone()
            _launch(kernel, Y1, C1,
                    tuple(o[b * n:(b + 1) * n] for o in ops), w, h)
            assert torch.equal(Y1, Yk[b]) and torch.equal(C1, Ck[b])
    return Y0, C0, ops, Yk, Ck


@pytest.mark.parametrize("B", BATCHES)
@pytest.mark.parametrize("kernel", ["K2", "K3"])
def test_wavefront_batched_equals_plain_and_single_launches(cuda, kernel, B):
    _check_wave_batch(cuda, kernel, B, 13, 6, seed=600 + B)
    # the last launch: one picture of 6 rows, one cluster of 8 CTAs
    assert KW.last_grid(KW.INTRA if kernel == "K2" else KW.DEBLOCK) == 8


@pytest.mark.parametrize("kernel", ["K2", "K3"])
def test_wavefront_batch_at_1080p(cuda, kernel):
    """4 x 68 rows: more CTAs than SMs, one cooperative launch."""
    _check_wave_batch(cuda, kernel, 4, 120, 68, seed=700, singles=False)
    which = KW.INTRA if kernel == "K2" else KW.DEBLOCK
    assert KW.last_grid(which) == min(4 * 68, KW.last_resident(which))


@pytest.mark.parametrize("kernel", ["K2", "K3"])
def test_wavefront_batch_streams_do_not_meet(cuda, kernel):
    """The first row of a later stream reads nothing of the stream above
    it: with that stream's planes and operands replaced by others, the
    later streams' results stay as they were."""
    w, h, B = 9, 4, 3
    n = w * h
    Y0, C0, ops, Yk, Ck = _check_wave_batch(cuda, kernel, B, w, h, seed=810)
    Ya, Ca, opa = _wave_batch(cuda, kernel, B, w, h, seed=877)
    Y2, C2 = Y0.clone(), C0.clone()
    Y2[0], C2[0] = Ya[1], Ca[1]                # another first stream
    ops2 = tuple(torch.cat([a[n:2 * n], o[n:]]) for a, o in zip(opa, ops))
    _launch(kernel, Y2, C2, ops2, w, h)
    torch.cuda.synchronize()
    assert torch.equal(Y2[1:], Yk[1:]) and torch.equal(C2[1:], Ck[1:])
    assert not torch.equal(Y2[0], Yk[0])


@pytest.mark.parametrize("kernel", ["K2", "K3"])
def test_wavefront_batch_on_a_capped_grid(cuda, kernel):
    """3 streams of 3 rows on one cluster (a cap of 12 CTAs is one whole
    cluster of 8): a CTA walks rows of two streams, and the rows of a
    stream are no multiple of the cluster; then 8 streams of 7 rows (56
    rows, 7 row blocks) on that one cluster."""
    which = KW.INTRA if kernel == "K2" else KW.DEBLOCK
    old = KW.set_max_ctas(12)
    try:
        _check_wave_batch(cuda, kernel, 3, 17, 3, seed=900, singles=False)
        assert KW.last_grid(which) == 8
        _check_wave_batch(cuda, kernel, 8, 5, 7, seed=901, singles=False)
        assert KW.last_grid(which) == 8
    finally:
        KW.set_max_ctas(old)
    _check_wave_batch(cuda, kernel, 3, 17, 3, seed=900, singles=False)
    assert KW.last_grid(which) == 16


# (w, h, B): clusters of 8 rows that start in one picture and end in the
# next, at several offsets
SPANS = [(9, 5, 3), (4, 9, 2), (6, 3, 5), (11, 12, 2)]


@pytest.mark.parametrize("geom", SPANS, ids=lambda g: f"{g[0]}x{g[1]}x{g[2]}")
@pytest.mark.parametrize("kernel", ["K2", "K3"])
def test_wavefront_cluster_spans_two_pictures(cuda, kernel, geom):
    """A cluster whose ranks hold the last rows of one picture and the
    first rows of the next: the ring never carries a row across the seam,
    and each picture's first row waits for nothing."""
    w, h, B = geom
    assert any(r // h != (r + 1) // h for r in range(B * h - 1)
               if (r + 1) % KW.CLUSTER)
    _check_wave_batch(cuda, kernel, B, w, h, seed=1100 + h)


@pytest.mark.parametrize("kernel", ["K2", "K3"])
def test_captured_cluster_launch_replays_byte_equal(cuda, kernel):
    """Stream capture records the clustered cooperative launch (and its
    counter memset); the graph's replays give the plain version's bytes."""
    w, h, B = 13, 10, 2                 # 20 rows: 3 clusters, one spans
    which = KW.INTRA if kernel == "K2" else KW.DEBLOCK
    Y0, C0, ops = _wave_batch(cuda, kernel, B, w, h, seed=1200)
    Yp, Cp = Y0.clone(), C0.clone()
    _plain(kernel, Yp, Cp, ops, w, h)
    Yk, Ck = Y0.clone(), C0.clone()
    ws = torch.zeros(B * h, dtype=torch.int32, device=cuda)
    wave = KW.intra_wavefront if kernel == "K2" else KW.deblock_wavefront

    def step():
        Yk.copy_(Y0)
        Ck.copy_(C0)
        wave(Yk, Ck, *ops, w, h, workspace=ws)

    step()                              # eager: builds, sizes the grid
    torch.cuda.synchronize()
    assert torch.equal(Yk, Yp) and torch.equal(Ck, Cp)
    KW.take_captured(which)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        step()
    assert KW.take_captured(which) == 1
    for _ in range(3):
        Yk.zero_()
        Ck.zero_()
        g.replay()
        torch.cuda.synchronize()
        assert torch.equal(Yk, Yp) and torch.equal(Ck, Cp)
    assert KW.last_cluster(which) == KW.CLUSTER


@pytest.mark.parametrize("kernel", ["K2", "K3"])
def test_wavefront_batches_in_turn_on_one_workspace(cuda, kernel):
    """Rounds of different sizes one after the other (streams leave): the
    counters of a wider round must not leak into a narrower one."""
    for rnd, B in enumerate((3, 8, 1, 2, 8, 3)):
        _check_wave_batch(cuda, kernel, B, 10, 5, seed=950 + rnd,
                          singles=False)


def test_k3_concealed_stream_inside_a_batch(cuda):
    """A wholly concealed picture is not deblocked: its rows are idle in
    the same launch and its planes stay as they were."""
    w, h, B = 8, 5, 3
    Y0, C0, ops = _wave_batch(cuda, "K3", B, w, h, seed=0)   # kinds i, m, idle
    Y0[1], C0[1] = Y0[0], C0[0]
    ops = (torch.cat([ops[0][:w * h]] * 2 + [ops[0][2 * w * h:]]),)
    skip = torch.tensor([0, 1, 0], dtype=torch.int32, device=cuda)
    Yk, Ck, Yp, Cp = Y0.clone(), C0.clone(), Y0.clone(), C0.clone()
    KW.device_launches(KW.DEBLOCK, reset=True)
    _launch("K3", Yk, Ck, ops, w, h, skip=skip)
    torch.cuda.synchronize()
    assert KW.device_launches(KW.DEBLOCK) == 1
    _plain("K3", Yp, Cp, ops, w, h, skip=skip)
    assert torch.equal(Yk, Yp) and torch.equal(Ck, Cp)
    assert torch.equal(Yk[1], Y0[1]) and torch.equal(Ck[1], C0[1])
    assert not torch.equal(Yk[0], Y0[0])      # the same picture, filtered


def test_handoff_probe_takes_a_batch(cuda):
    KW.device_launches(KW.PROBE, reset=True)
    for B in (1, 4, 8):
        KW.handoff_probe(120, 68, cuda, batch=B)
        torch.cuda.synchronize()
        assert KW.last_grid(KW.PROBE) == min(-(-68 * B // 8) * 8,
                                             KW.last_resident(KW.PROBE))
    assert KW.device_launches(KW.PROBE) == 3


LOCKSTEP = [((4, 3), [(11, 3), (12, 3), (13, 3)]),
            ((6, 5), [(21, 2), (22, 4), (23, 3)]),
            ((12, 8), [(41, 3), (42, 1), (43, 4), (44, 2)])]


@pytest.mark.parametrize("geom,specs", LOCKSTEP,
                         ids=lambda v: "x".join(map(str, v))
                         if isinstance(v, tuple) else None)
def test_cuda_lockstep_equals_single_stream(cuda, geom, specs):
    """decode_streams_lockstep on the card: each stream byte-equal to the
    port's NumPy path, K1 / K2 / K3 once a round."""
    from broadway_tpu_torch.parallel.streams import decode_streams_lockstep
    datas = [streams.inter_stream(width_mbs=geom[0], height_mbs=geom[1],
                                  n_frames=n, seed=s, deblock=True,
                                  mvd_range=30)[0] for s, n in specs]
    wants = [[o.frame.tobytes() for o in
              Decoder(device="cpu", recon="numpy").decode_annexb(d)]
             for d in datas]
    before = (K1.mc_predict.launches, KW.intra_wavefront.launches,
              KW.deblock_wavefront.launches)
    st = {}
    gots = decode_streams_lockstep(datas, device="cuda", parallel_slices=2,
                                   stats=st)
    assert gots == wants
    rounds = max(n for _, n in specs)
    assert st["rounds"] == rounds and len(st["batches"]) == rounds
    assert (K1.mc_predict.launches - before[0],
            KW.intra_wavefront.launches - before[1],
            KW.deblock_wavefront.launches - before[2]) == (rounds,) * 3


# ---------------------------------------------------------------------------
# launches from several host threads: K2 / K3's memset and launch are one
# unit in stream order, each decoder has its own progress counters, and
# the launch counts are exact
# ---------------------------------------------------------------------------

def test_k2_k3_from_two_threads_on_the_default_stream(cuda):
    """Two threads launch K2 then K3 200 times each on the default stream
    with the wrappers' shared per-stream counters (no caller workspace):
    every result equals the plain versions', and the wrapper and device
    counts gain exactly 400 each."""
    import threading
    w, h, reps = 40, 30, 200
    cases = []
    for seed in (700, 710):
        Y0, C0 = (_t(a, cuda) for a in synth.planes(w, h, seed))
        RY, RC, Pi = (_t(a, cuda) for a in synth.intra_operands(
            w, h, seed + 1, "mixed"))
        Pd = _t(synth.deblock_operands(w, h, seed + 2, "mixed"), cuda)
        Yp, Cp = Y0.clone(), C0.clone()
        intra.intra_wavefront_plain(Yp, Cp, RY, RC, Pi, w, h)
        deblock.deblock_wavefront_plain(Yp, Cp, Pd, w, h)
        cases.append((Y0, C0, RY, RC, Pi, Pd, Yp, Cp))
    torch.cuda.synchronize()
    outs, errors = [[], []], []

    def run(i):
        try:
            Y0, C0, RY, RC, Pi, Pd = cases[i][:6]
            for _ in range(reps):
                Y, C = Y0.clone(), C0.clone()
                KW.intra_wavefront(Y, C, RY, RC, Pi, w, h)
                KW.deblock_wavefront(Y, C, Pd, w, h)
                outs[i].append((Y, C))
        except Exception as e:         # re-raised below, on the test's thread
            errors.append(e)

    before = (KW.intra_wavefront.launches, KW.deblock_wavefront.launches)
    KW.device_launches(KW.INTRA, reset=True)
    KW.device_launches(KW.DEBLOCK, reset=True)
    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    torch.cuda.synchronize()
    for i, (*_, Yp, Cp) in enumerate(cases):
        bad = [r for r, (Y, C) in enumerate(outs[i])
               if not (torch.equal(Y, Yp) and torch.equal(C, Cp))]
        assert len(outs[i]) == reps and not bad, (i, bad[:10])
    assert (KW.intra_wavefront.launches - before[0],
            KW.deblock_wavefront.launches - before[1]) == (2 * reps,) * 2
    assert KW.device_launches(KW.INTRA) == 2 * reps
    assert KW.device_launches(KW.DEBLOCK) == 2 * reps


def test_two_pumped_decoders_on_two_threads(cuda):
    """Two decoders with the pump (the default on the card), fed from two
    threads at once, each decoding its stream three times: the frames of
    two sequential un-pumped decoders."""
    import threading
    datas = [streams.realistic_stream(width_mbs=12, height_mbs=8, n_frames=6,
                                      n_slices=3, seed=s)[0] for s in (5, 6)]
    wants = [[o.frame.tobytes() for o in
              Decoder(device=cuda, async_pump=False).decode_annexb(d)]
             for d in datas]
    gots, errors = [None, None], []

    def run(i):
        try:
            dec = Decoder(device=cuda, parallel_slices=2)
            assert dec.async_pump
            try:
                gots[i] = [[o.frame.tobytes()
                            for o in dec.decode_annexb(datas[i])]
                           for _ in range(3)]
            finally:
                dec.close()
        except Exception as e:         # re-raised below, on the test's thread
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    for got, want in zip(gots, wants):
        assert got == [want] * 3


def test_pump_runs_on_the_feed_threads_card_and_stream(cuda, monkeypatch):
    """The pump's worker runs each step under the decoder's card and on
    the stream that was current on the feed thread when the picture was
    queued (both are per thread in CUDA), the eager step of a key's first
    picture and the graph replays alike; a prefetch the worker starts
    waits on that stream."""
    from broadway_tpu_torch.core import decoder as DEC
    from broadway_tpu_torch.core import graphs as GR
    seen, replays = [], []
    step, launch = DEC.Decoder._picture_step, GR.GroupGraph._launch

    def where():
        return (torch.cuda.current_device(),
                torch.cuda.current_stream().cuda_stream)

    def spy(*a, **k):
        seen.append(where())
        return step(*a, **k)

    def launch_spy(*a, **k):
        replays.append(where())
        return launch(*a, **k)

    monkeypatch.setattr(DEC.Decoder, "_picture_step", spy)
    monkeypatch.setattr(GR.GroupGraph, "_launch", launch_spy)
    data = STREAMS["realistic"]()
    want = [o.frame.tobytes() for o in
            Decoder(device="cpu", recon="numpy").decode_annexb(data)]
    side = torch.cuda.Stream(cuda)
    with torch.cuda.stream(side):
        dec = Decoder(device=cuda, prefetch_outputs=True)
        got = [o.frame.tobytes() for o in dec.decode_annexb(data)]
        dec.close()
    assert got == want
    assert seen == [(cuda.index or 0, side.cuda_stream)] * len(want)
    assert replays and \
        replays == [(cuda.index or 0, side.cuda_stream)] * len(replays)

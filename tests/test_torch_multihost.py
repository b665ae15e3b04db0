"""Multi-host decode of the port (``broadway_tpu_torch.parallel.multihost``)
without a cluster: two real OS processes join one ``torch.distributed``
job over gloo on a free local port, as tests/test_multihost.py runs the
JAX package's. Each decodes its share of the streams (round-robin by
rank) and the one exchange gives both every stream's frames, byte-equal
to the JAX package's decoder (computed here, in the parent) and to the
port's single decoder (computed in each worker). With ``sp_bands=2`` each
stream is band-sharded over the process's own devices (the CPU twice):
idc 2, idc 0 and an unaligned stream whose pictures are declined. The
launcher's LOCAL_RANK reaches the card choice, and the exchange runs over
a gloo group of the job. Each process has its own time limit, so a hang
fails the test instead of holding the suite.

``rank_cards``, the card choice of a rank, is a pure function and is
held to its cases without processes."""

import os
import pickle
import socket
import subprocess
import sys

import pytest

import streams
from broadway_tpu_torch.parallel.multihost import rank_cards

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 240

_WORKER = r"""
import pickle, sys
pid, port, path = int(sys.argv[1]), sys.argv[2], sys.argv[3]
sys.path.insert(0, %(repo)r)
from broadway_tpu_torch.parallel.multihost import (
    decode_streams_multihost, global_dp_sp_mesh, init_multihost)
init_multihost(f"localhost:{port}", 2, pid, backend="gloo")
import torch.distributed as dist
from broadway_tpu_torch.parallel import multihost as MH
assert dist.get_world_size() == 2 and dist.get_rank() == pid
assert MH.local_rank() == pid
backends, gather = [], dist.all_gather_object

def spy(out, obj, group=None):
    backends.append(dist.get_backend(group))
    return gather(out, obj, group=group)

dist.all_gather_object = spy
with open(path, "rb") as f:
    case = pickle.load(f)
from broadway_tpu_torch.core.decoder import Decoder
own = [[o.frame.tobytes() for o in Decoder(device="cpu").decode_annexb(d)]
       for d in case["datas"]]
assert own == case["wants"], "single decoder differs from the JAX package"
got = decode_streams_multihost(case["datas"], device="cpu",
                               sp_bands=case["sp_bands"])
assert got == case["wants"], [i for i, (a, b) in
                              enumerate(zip(got, case["wants"])) if a != b]
assert backends == ["gloo"], backends
grid = global_dp_sp_mesh(2, device="cpu")
assert [[r for r, _ in row] for row in grid] == [[0, 0], [1, 1]]
assert all(str(d) == "cpu" for row in grid for _, d in row)
dist.destroy_process_group()
print(f"MULTIHOST-OK-{pid}", flush=True)
"""


def _datas(sp_bands):
    if sp_bands == 1:
        datas = [streams.inter_stream(width_mbs=4, height_mbs=3, n_frames=3,
                                      seed=s, deblock=True, mvd_range=20)[0]
                 for s in (41, 42, 43)]
        # a mid-stream resolution change: frames of two sizes in one stream
        datas.append(
            streams.inter_stream(width_mbs=4, height_mbs=3, n_frames=2,
                                 seed=61, deblock=True)[0]
            + streams.inter_stream(width_mbs=6, height_mbs=5, n_frames=2,
                                   seed=62, deblock=True)[0])
        return datas
    return [streams.banded_stream(n_bands=2, height_mbs=4, n_frames=3,
                                  seed=705)[0],
            streams.banded_stream(n_bands=2, height_mbs=4, n_frames=3,
                                  seed=706, deblock_idc=0)[0],
            streams.multislice_stream(width_mbs=4, height_mbs=4, n_frames=2,
                                      n_slices=3, seed=708)[0]]


@pytest.mark.parametrize("sp_bands", [1, 2])
def test_two_process_decode(sp_bands, tmp_path):
    from broadway_tpu.core.decoder import Decoder as BaseDecoder

    datas = _datas(sp_bands)
    wants = [[o.frame.tobytes() for o in BaseDecoder().decode_annexb(d)]
             for d in datas]
    path = tmp_path / "case.pkl"
    with open(path, "wb") as f:
        pickle.dump({"datas": datas, "wants": wants, "sp_bands": sp_bands}, f)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if k != "CUDA_VISIBLE_DEVICES"}
    script = _WORKER % {"repo": REPO}
    procs = [subprocess.Popen(
        [sys.executable, "-c", script, str(i), str(port), str(path)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        env=dict(env, LOCAL_RANK=str(i)), cwd=str(tmp_path))
        for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S))
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        for p in procs:
            p.communicate()
        pytest.fail(f"a worker ran past {TIMEOUT_S} s")
    for i, (p, (so, se)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i}:\n{so[-2000:]}\n{se[-4000:]}"
        assert f"MULTIHOST-OK-{i}" in so


# (world size, cards a host, cards a rank, [local rank or None a rank],
#  each rank's cards)
RANK_CARDS = {
    "one_each": (2, 4, 1, [None, None], [[0], [1]]),
    "blocks_of_two": (2, 4, 2, [None, None], [[0, 1], [2, 3]]),
    "two_ranks_one_card": (2, 1, 1, [None, None], [[0], [0]]),
    "three_ranks_two_cards": (3, 2, 1, [None] * 3, [[0], [1], [0]]),
    "blocks_wrap": (2, 3, 2, [None, None], [[0, 1], [2, 0]]),
    "two_hosts_local_rank": (4, 2, 1, [0, 1, 0, 1], [[0], [1], [0], [1]]),
}


@pytest.mark.parametrize("name", sorted(RANK_CARDS))
def test_rank_cards(name):
    """Disjoint cards while the host has enough, shared cards otherwise;
    the local rank, where the launcher gives one, places a rank on its
    host."""
    world, count, n, local, want = RANK_CARDS[name]
    got = [rank_cards(r, world, count, n, local[r]) for r in range(world)]
    assert got == want
    flat = [c for cards in got for c in cards]
    assert (len(set(flat)) == len(flat)) == (name in ("one_each",
                                                      "blocks_of_two"))


def test_rank_cards_refuses_a_rank_outside_the_world():
    with pytest.raises(ValueError):
        rank_cards(2, 2, 4)
    with pytest.raises(ValueError):
        rank_cards(0, 1, 0)

"""Multi-host decode: streams sharded over processes, the counterpart of
``broadway_tpu/parallel/multihost.py``.

The reference's outermost parallel axis is independent decoder instances
(TestBenchMultipleInstance.c; storyDemo.html's six players). Here each
process (a host, or one process per card or group of cards of a host)
decodes its own streams, round-robin by rank, with no traffic between
processes while it decodes; a picture's MB-row bands may ride the
process's own cards (``sp_bands``, parallel/slices.py). The only exchange
is the results, once, at the end, as host bytes (the JAX package's
``process_allgather``): over a gloo group of the job whatever the job's
backend, since there is no device tensor to exchange.

A rank's cards are a block of its host's cards picked by its local rank
(``rank_cards``: ``LOCAL_RANK`` when the launcher sets it, else the
rank), so that the ranks of one host decode on disjoint cards when there
are enough of them, and share cards otherwise; ``init_multihost`` makes
the first of them the process's current card.

``torch.distributed`` stands in for ``jax.distributed``: nothing on a host
tells a program of its cluster, so the caller gives the address of rank 0,
the world size and its rank (``init_multihost``). The tests run two real
processes on the CPU over gloo.
"""

from __future__ import annotations

import datetime
import os
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from ..core.decoder import Decoder
from .slices import decode_stream_sliced
from .streams import make_dp_mesh


def local_rank() -> Optional[int]:
    """This process's rank on its host as the launcher gives it
    (``LOCAL_RANK``, as torchrun sets it), or None."""
    v = os.environ.get("LOCAL_RANK")
    return None if v is None else int(v)


def rank_cards(rank: int, world_size: int, device_count: int, n: int = 1,
               local: Optional[int] = None) -> List[int]:
    """The indices of the n cards of a rank among its host's device_count:
    the block of n that starts at card (local * n) % device_count, local
    being its local rank (the rank itself when None: every rank on one
    host), wrapping round. Ranks of one host get disjoint blocks while
    their local ranks times n stay below the card count; beyond that they
    share cards (two ranks on one card, say), which decodes correctly but
    shares the card's time."""
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} outside a world of {world_size}")
    if device_count < 1 or n < 1:
        raise ValueError(f"{n} cards of {device_count}")
    first = ((rank if local is None else local) * n) % device_count
    return [(first + i) % device_count for i in range(n)]


def init_multihost(coordinator_address: str, num_processes: int,
                   process_id: int, backend: str = "nccl",
                   timeout_s: float = 600.0) -> None:
    """Join this process to a decode job of num_processes processes:
    ``torch.distributed.init_process_group`` over TCP at
    coordinator_address ("host:port", where rank 0 listens). backend
    "nccl" for cards, "gloo" on the CPU. Where CUDA is available, the
    rank's first card (``rank_cards``) becomes the current card before
    the job's first collective."""
    if torch.cuda.is_available():
        torch.cuda.set_device(rank_cards(process_id, num_processes,
                                         torch.cuda.device_count(),
                                         local=local_rank())[0])
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout_s))


def local_devices(device="cuda", n: int = None) -> List[torch.device]:
    """This process's devices of one type. CUDA: its block of n cards
    (``rank_cards`` of its rank and local rank in the job; rank 0 of one
    outside a job), by default every card it sees; the CPU: the CPU n
    times (once by default)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return make_dp_mesh([dev] * (n or 1))
    count = len(make_dp_mesh())
    rank, world = ((dist.get_rank(), dist.get_world_size())
                   if dist.is_initialized() else (0, 1))
    return [torch.device("cuda", i) for i in rank_cards(
        rank, world, count, count if n is None else n, local_rank())]


def global_dp_sp_mesh(n_sp: int = None, device="cuda") -> List[list]:
    """The global grid: row r is rank r ("dp", across processes), its
    entries (r, device) the n_sp devices of that rank ("sp"): on CUDA the
    cards rank r picks (``rank_cards``) when its local rank is r (every
    rank on one host), this rank's own row as ``local_devices`` gives it;
    a rank drives only its own row."""
    world, me = dist.get_world_size(), dist.get_rank()
    dev = torch.device(device)
    rows = []
    for r in range(world):
        if r == me or dev.type != "cuda":
            devs = local_devices(device, n_sp)
        else:
            count = len(make_dp_mesh())
            devs = [torch.device("cuda", i) for i in rank_cards(
                r, world, count, count if n_sp is None else n_sp)]
        rows.append([(r, d) for d in devs])
    return rows


def decode_streams_multihost(datas: Sequence[bytes], device="cuda",
                             sp_bands: int = 1,
                             parallel_slices: int = 0) -> List[List[bytes]]:
    """Decode N streams over the processes of the job: rank p decodes the
    streams i with i % world_size == p on its own devices (`device`: on
    CUDA the rank's card, ``local_devices``; sp_bands > 1 band-shards each
    picture over the rank's sp_bands devices, ``decode_stream_sliced``),
    then one exchange gives every rank every stream's display-order
    frames.

    The exchange is ``all_gather_object`` over a gloo group of the job
    (made here, whatever the job's backend: the frames are host bytes,
    as in the JAX package's ``process_allgather``, and NCCL would stage
    them on a card, which it refuses to two ranks of one card): each
    rank's {stream: frames} pickled, sizes first, then the bytes. The JAX
    package gathers one padded u8 tensor with a header per stream and a
    per-frame size table (a mid-stream resolution change makes frames of
    two sizes), which needs a max-size round first and caps the frames
    per stream; here the bytes travel as they are, frames of any size and
    count."""
    world, rank = dist.get_world_size(), dist.get_rank()
    devs = local_devices(device, sp_bands)     # the decoder's on devs[0]
    mine = {}
    cache = {}
    for i in range(rank, len(datas), world):
        if sp_bands > 1:
            mine[i] = decode_stream_sliced(
                datas[i], devs, sp_bands, parallel_slices=parallel_slices,
                cache=cache)
        else:
            dec = Decoder(device=devs[0], parallel_slices=parallel_slices)
            try:
                outs = dec.decode_annexb(datas[i])
            finally:
                dec.close()
            for o in outs:
                o.frame.start_fetch()
            mine[i] = [o.frame.tobytes() for o in outs]
    gathered = [None] * world
    group = dist.new_group(backend="gloo")
    try:
        dist.all_gather_object(gathered, mine, group=group)
    finally:
        dist.destroy_process_group(group)
    out: List[List[bytes]] = []
    for i in range(len(datas)):
        out.append(gathered[i % world][i])
    return out

"""Copies between the cards of one host, wrapper of ``csrc/peer.cu``: the
band-sharded decode's halo chain and gather over a mesh of several cards
(parallel/slices.py), the counterparts of the JAX package's ``ppermute``
and ``all_gather`` over the chips of a mesh.

``copy(dst, src)`` is one ``cudaMemcpyAsync`` between peer addresses per
contiguous piece, enqueued on the RECEIVER's current stream, so that a
capture on that card records it into that card's graph (PyTorch's own
``copy_`` between cards runs on the sender's stream and joins both cards'
streams by events, which a capture of one card refuses). The caller
orders it after the sender's work (an event). ``enable(devices)`` checks
and enables peer access for every ordered pair of distinct cards and
raises, naming the pair, where the card has none: a copy never goes
through host memory quietly. On the CPU both are plain: ``dst.copy_``.
"""

from __future__ import annotations

from typing import Sequence

import torch

from . import _build

_enabled = set()      # (device, peer) pairs whose access is on


def pieces(dst: torch.Tensor, src: torch.Tensor):
    """(dst, src) as pairs of contiguous pieces: the two themselves, or
    their entries along the leading axis when only those are contiguous
    (a chroma band [2, rows, W/2] cut from a taller plane)."""
    if dst.is_contiguous() and src.is_contiguous():
        return [(dst, src)]
    if dst.dim() > 1 and all(t.is_contiguous() for t in (*dst, *src)):
        return list(zip(dst, src))
    raise ValueError(f"a copy of shape {tuple(dst.shape)} with strides "
                     f"{dst.stride()} and {src.stride()} is not contiguous "
                     "by its leading axis")


def enable(devices: Sequence[torch.device]) -> None:
    """Peer access for every ordered pair of the distinct CUDA devices:
    raises ValueError naming a pair that
    ``torch.cuda.can_device_access_peer`` refuses, RuntimeError if
    enabling fails."""
    cards = sorted({d.index for d in devices if d.type == "cuda"})
    for a in cards:
        for b in cards:
            if a == b or (a, b) in _enabled:
                continue
            if not torch.cuda.can_device_access_peer(a, b):
                raise ValueError(f"cuda:{a} cannot access cuda:{b}'s memory "
                                 "(no peer access): the band copies between "
                                 "them would go through the host")
            with torch.cuda.device(a):
                _build.check(_build.load().bw_peer_enable(a, b),
                             f"bw_peer_enable(cuda:{a}, cuda:{b})")
            _enabled.add((a, b))


def copy(dst: torch.Tensor, src: torch.Tensor) -> None:
    """dst <- src, both of one shape and type: on the CPU ``dst.copy_``;
    between CUDA devices (or on one) a copy per contiguous piece on dst's
    card's current stream. Raises for a pair of cards whose peer access
    ``enable`` has not turned on."""
    if dst.shape != src.shape or dst.dtype != src.dtype:
        raise ValueError(f"copy of {src.dtype} {tuple(src.shape)} into "
                         f"{dst.dtype} {tuple(dst.shape)}")
    if dst.device.type == "cpu" and src.device.type == "cpu":
        dst.copy_(src)
        return
    if dst.device.type != "cuda" or src.device.type != "cuda":
        raise ValueError(f"peer.copy from {src.device} to {dst.device}")
    a, b = dst.device.index, src.device.index
    if a != b and (a, b) not in _enabled:
        raise RuntimeError(f"peer access of cuda:{a} to cuda:{b} is not "
                           "enabled (peer.enable)")
    lib = _build.load()
    stream = torch.cuda.current_stream(dst.device).cuda_stream
    with torch.cuda.device(dst.device):
        for d, s in pieces(dst, src):
            _build.check(lib.bw_peer_copy(d.data_ptr(), s.data_ptr(),
                                          d.numel() * d.element_size(),
                                          stream), "bw_peer_copy")

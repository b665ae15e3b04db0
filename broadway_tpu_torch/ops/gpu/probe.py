"""Timing aids on the card, wrappers of ``csrc/probe.cu``. No decoding
path calls anything here; ``chip_smoke.py`` and the card tests do."""

from __future__ import annotations

import torch

from . import _build


def _stream(device, what: str) -> int:
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {dev}")
    return torch.cuda.current_stream(dev).cuda_stream


def launch_probe(ctas: int, threads: int, device) -> None:
    """Launch an empty kernel of `ctas` CTAs of `threads` threads: what
    the launch of that grid alone costs on this card."""
    err = _build.load().bw_launch_probe(ctas, threads,
                                        _stream(device, "launch_probe"))
    _build.check(err, "bw_launch_probe")


def hold_stream(cycles: int, device) -> None:
    """Keep the current stream busy for `cycles` SM clocks (one spinning
    thread). Launches enqueued behind it pile up, so CUDA events around
    them read device time even where one launch is shorter than its
    enqueue on the host."""
    err = _build.load().bw_hold_stream(int(cycles),
                                       _stream(device, "hold_stream"))
    _build.check(err, "bw_hold_stream")

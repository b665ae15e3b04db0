"""K2 (intra) and K3 (deblock): wrappers of ``csrc/intra.cu`` and
``csrc/deblock.cu``.

Replace the Pallas kernels of ``broadway_tpu/ops/tpu/wavefront_pallas.py``
(``_intra_kernel`` via ``intra_wavefront``, ``_db_kernel`` via
``deblock_wavefront``). Both work in place on raster uint8 planes,
without the TPU's diagonal-major packing (``WavefrontLayout``) or its
one-hot MXU transposes: ONE persistent kernel launch per picture on the
current stream, one CUDA block per MB row, rows kept in x + 2y order by
per-row progress counters (``csrc/wavefront.cuh``). A batch of pictures
of one geometry (the streams of a lockstep round; the TPU kernels' LANE
axis) is one launch too: its rows are every picture's rows, and each
picture's first row starts at once. The counters are a small int32
workspace that this module owns per device and stream; a caller whose
launches may run beside others on the same stream (a captured CUDA graph,
``core/graphs.py``; a ``Decoder``) passes its own (``workspace=``). The
zeroing of the counters and the launch are one unit in stream order
(``csrc/wavefront.cuh``), so threads that share a stream and its
counters cannot interleave them.

Each wrapper takes the plain version (ops/gpu/intra.py, deblock.py) for
CPU tensors and launches the kernel for CUDA tensors; ``launches``
counts the wrapper calls whose kernel ran (a launch recorded by a graph
capture counts at each replay, ``_build.count_launch``). The launch is
cooperative: if the card refuses it, the wrapper raises, and never goes
back to per-diagonal launches or to the plain version.
"""

from __future__ import annotations

import threading

import torch

from . import _build
from .deblock import N_PARAMS as DB_PARAMS, deblock_wavefront_plain
from .intra import N_PARAMS as IN_PARAMS, intra_wavefront_plain
from .tables import tables


INTRA, DEBLOCK, PROBE = 0, 1, 2      # bwwf::Which of csrc/wavefront.cuh

_progress = {}      # (device index, stream) -> int32 [rows] counters
_progress_lock = threading.Lock()


def _check_planes(Y, C, w_mbs, h_mbs) -> int:
    """Raise unless Y [H, W] and C [2, H/2, W/2] (one picture) or Y
    [B, H, W] and C [B, 2, H/2, W/2] (a batch) are what the kernels' raw
    pointers assume; returns the number of pictures."""
    dev = Y.device
    H, W = 16 * h_mbs, 16 * w_mbs
    lead = tuple(Y.shape[:-2])
    if len(lead) > 1 or (lead and lead[0] < 1):
        raise ValueError(f"Y has shape {tuple(Y.shape)}, expected [H, W] or "
                         "[B, H, W]")
    _build.check_tensor(Y, "Y", torch.uint8, lead + (H, W), dev)
    _build.check_tensor(C, "C", torch.uint8, lead + (2, H // 2, W // 2), dev)
    if Y.data_ptr() % 4 or C.data_ptr() % 4:
        raise ValueError("Y and C must be 4-byte aligned (the kernels move "
                         "32-bit words)")
    return lead[0] if lead else 1


def _workspace(dev: torch.device, stream: int, rows: int,
               own: torch.Tensor = None) -> torch.Tensor:
    """The progress counters (one per MB row of every picture of the
    launch) for launches on (dev, stream): kernels on one stream run one
    after the other, so they share one workspace. `own` is the caller's
    workspace instead (int32, at least `rows` counters, on dev)."""
    if own is not None:
        if own.device != dev or own.dtype != torch.int32 or \
                not own.is_contiguous() or own.numel() < rows:
            raise ValueError(f"workspace {own.dtype} [{own.numel()}] on "
                             f"{own.device}: need {rows} contiguous int32 "
                             f"counters on {dev}")
        return own
    key = (dev.index, stream)
    with _progress_lock:
        ws = _progress.get(key)
        if ws is None or ws.numel() < rows:
            ws = torch.zeros(max(rows, 256), dtype=torch.int32, device=dev)
            _progress[key] = ws
    return ws


def device_launches(which: int, reset: bool = False) -> int:
    """Kernel launches made so far by wavefront `which` (INTRA, DEBLOCK,
    PROBE), as counted next to the launch in csrc/wavefront.cuh."""
    return _build.load().bw_wavefront_device_launches(which, int(reset))


def take_captured(which: int) -> int:
    """Launches of wavefront `which` that stream captures on this thread
    recorded since the last call (they did not run; the count is zeroed)."""
    return _build.load().bw_wavefront_take_captured(which)


def add_launches(which: int, n: int) -> None:
    """Add n launches that ran to wavefront `which`'s device count (the
    launches of a graph replay)."""
    _build.check(_build.load().bw_wavefront_add_launches(which, n),
                 "bw_wavefront_add_launches")


def last_grid(which: int) -> int:
    """CTAs in the newest launch of wavefront `which`."""
    return _build.load().bw_wavefront_last_grid(which)


def set_max_ctas(n: int) -> int:
    """A test-only knob, not part of the decoding interface: cap every
    wavefront launch at n CTAs (0 lifts the cap) so that a small picture
    drives the more-rows-than-CTAs stride; returns the previous cap. The
    cap is one process-wide int read without a lock by every launch, so
    it is not safe beside a decoder's slice-pool threads or a decoder
    running on another thread: set it only while nothing else decodes.
    No decoding path calls this."""
    return _build.load().bw_wavefront_set_max_ctas(n)


def last_resident(which: int) -> int:
    """CTAs of wavefront `which` that the card could hold at once, as the
    occupancy calculator said at its newest launch: a launch with more
    rows than this strides its rows over that many CTAs."""
    return _build.load().bw_wavefront_last_resident(which)


def handoff_probe(w_mbs: int, h_mbs: int, device, batch: int = 1) -> None:
    """Launch the wavefront scaffold with an empty MB body over `batch`
    grids of w_mbs x h_mbs side by side: w + 2 (h - 1) dependent hand-offs
    in each and nothing else (the dependency floor of K2 and K3 on this
    card at that batch)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError("handoff_probe runs on a CUDA device only")
    if batch < 1:
        raise ValueError(f"batch {batch} < 1")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    stream = torch.cuda.current_stream(dev).cuda_stream
    ws = _workspace(dev, stream, batch * h_mbs)
    err = _build.load().bw_handoff_probe(ws.data_ptr(), w_mbs, h_mbs, batch,
                                         stream)
    _build.check(err, "bw_handoff_probe")


def intra_wavefront(Y: torch.Tensor, C: torch.Tensor, RY: torch.Tensor,
                    RC: torch.Tensor, P: torch.Tensor, w_mbs: int,
                    h_mbs: int, workspace: torch.Tensor = None) -> None:
    """Intra reconstruction in place. Y [H, W] u8 and C [2, H/2, W/2] u8
    hold the base planes; RY [n, 16, 16] and RC [n, 2, 8, 8] int32
    residuals; P [n, 32] int32 from ``intra.intra_params``. A batch of B
    pictures of one geometry is ONE launch: Y [B, H, W], C
    [B, 2, H/2, W/2], RY, RC and P with B*n rows, picture after picture.
    workspace: the caller's progress counters (int32, >= B*h_mbs), else
    this module's for the current stream."""
    if Y.device.type == "cpu":
        intra_wavefront_plain(Y, C, RY, RC, P, w_mbs, h_mbs)
        return
    if Y.device.type != "cuda":
        raise ValueError(f"intra_wavefront: unsupported device {Y.device}")
    dev = Y.device
    B = _check_planes(Y, C, w_mbs, h_mbs)
    n = B * w_mbs * h_mbs
    _build.check_tensor(RY, "RY", torch.int32, (n, 16, 16), dev)
    _build.check_tensor(RC, "RC", torch.int32, (n, 2, 8, 8), dev)
    _build.check_tensor(P, "P", torch.int32, (n, IN_PARAMS), dev)
    tab = tables(dev)["I4_KERNEL"]
    lib = _build.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    ws = _workspace(dev, stream, B * h_mbs, workspace)
    with torch.cuda.device(dev):     # the occupancy query and the launch
        err = lib.bw_intra_wavefront(
            Y.data_ptr(), C.data_ptr(), RY.data_ptr(), RC.data_ptr(),
            P.data_ptr(), tab.data_ptr(), ws.data_ptr(), w_mbs, h_mbs, B,
            stream)
    _build.check(err, "bw_intra_wavefront")
    _build.count_launch(intra_wavefront)


def deblock_wavefront(Y: torch.Tensor, C: torch.Tensor, P: torch.Tensor,
                      w_mbs: int, h_mbs: int, skip: torch.Tensor = None,
                      workspace: torch.Tensor = None) -> None:
    """Deblocking in place. Y [H, W] u8, C [2, H/2, W/2] u8, P [n, 64]
    int32 from ``deblock.deblock_params``. A batch of B pictures of one
    geometry is ONE launch: Y [B, H, W], C [B, 2, H/2, W/2], P [B*n, 64];
    skip (int32 [B] on the planes' device, or None) marks the pictures
    that are not filtered (a wholly concealed picture): their rows are
    idle in the same launch. workspace as for ``intra_wavefront``."""
    if Y.device.type == "cpu":
        deblock_wavefront_plain(Y, C, P, w_mbs, h_mbs, skip)
        return
    if Y.device.type != "cuda":
        raise ValueError(f"deblock_wavefront: unsupported device {Y.device}")
    dev = Y.device
    B = _check_planes(Y, C, w_mbs, h_mbs)
    _build.check_tensor(P, "P", torch.int32, (B * w_mbs * h_mbs, DB_PARAMS),
                        dev)
    if skip is not None:
        _build.check_tensor(skip, "skip", torch.int32, (B,), dev)
    lib = _build.load()
    stream = torch.cuda.current_stream(dev).cuda_stream
    ws = _workspace(dev, stream, B * h_mbs, workspace)
    with torch.cuda.device(dev):
        err = lib.bw_deblock_wavefront(
            Y.data_ptr(), C.data_ptr(), P.data_ptr(), ws.data_ptr(),
            None if skip is None else skip.data_ptr(), w_mbs, h_mbs, B,
            stream)
    _build.check(err, "bw_deblock_wavefront")
    _build.count_launch(deblock_wavefront)


intra_wavefront.launches = 0
deblock_wavefront.launches = 0

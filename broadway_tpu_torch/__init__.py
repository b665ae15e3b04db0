"""PyTorch/CUDA port of the broadway_tpu H.264 Baseline decode engine.

The host half (bitstream parsing, DPB/POC, concealment, the v2 packer)
is shared with ``broadway_tpu``; this package holds the device half:
the per-picture reconstruction pipeline as integer torch ops and three
hand-written CUDA kernels for NVIDIA Hopper (``csrc/``). Nothing here
imports JAX. Entry point: ``broadway_tpu_torch.core.decoder.Decoder``.
"""

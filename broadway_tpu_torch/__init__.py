"""PyTorch/CUDA port of the broadway_tpu H.264 Baseline decode engine.

A package of its own: the host half (bitstream parsing with a native C++
front end, DPB/POC, concealment, the v2 packer, a NumPy reference
backend, the test-stream generator) and the device half (the per-picture
reconstruction pipeline as integer torch ops and three hand-written CUDA
kernels for NVIDIA Hopper, ``csrc/``). It imports torch, never JAX and
nothing of ``broadway_tpu``. Entry point:
``broadway_tpu_torch.core.decoder.Decoder``.
"""

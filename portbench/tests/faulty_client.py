"""A client with a fault planted under the timed path, for the test that
``correct`` comes out false:

    python3 -m portbench.tests.faulty_client alter|unchanged

``alter``: every picture's step returns its picture with one byte
changed. ``unchanged``: every step after the first returns the first
picture again, as a step that leaves its state unchanged would."""

from __future__ import annotations

import sys

from broadway_tpu_torch.core import decoder as D
from broadway_tpu_torch.core.recon import TorchFrame

from portbench import client


def plant(fault: str) -> None:
    step = D.decode_picture_packed2
    first = []

    def faulty(*args, **kwargs):
        frame = step(*args, **kwargs)
        yuv = frame.yuv.clone()
        if fault == "alter":
            yuv[yuv.numel() // 2] ^= 1
        elif fault == "unchanged":
            if not first:
                first.append(yuv)
            yuv = first[0].clone()
        else:
            raise ValueError(fault)
        return TorchFrame(yuv, frame.dev_y.shape[1], frame.dev_y.shape[0])

    D.decode_picture_packed2 = faulty


if __name__ == "__main__":
    plant(sys.argv[1])
    sys.exit(client.main())

"""A lockstep client with a fault planted under the timed path, in one
stream of the group (the group's second), for the test that ``correct``
comes out false:

    python3 -m portbench.tests.faulty_lockstep_client alter|unchanged|half

``alter``: each of its pictures comes out of its round with one byte
changed. ``unchanged``: each after the first comes out as the first, as
a step that leaves its state unchanged would give it. ``half``: every
round steps only the first half of its streams and hands the rest their
frames, as a round that left half of its batch out would."""

from __future__ import annotations

import sys

from broadway_tpu_torch.core.recon import TorchFrame
from broadway_tpu_torch.parallel import streams as S

from portbench import lockstep_client

STREAM = 1


def plant(fault: str) -> None:
    step = S._round_step
    first = []

    def faulty(stacks, bufs, sub, slots, *rest):
        if fault == "half":
            n = max(1, len(sub) // 2)
            frames = step(stacks, bufs[:n], sub[:n], slots[:n], *rest)
            return [frames[j % n] for j in range(len(sub))]
        frames = list(step(stacks, bufs, sub, slots, *rest))
        if STREAM not in sub:
            return frames
        j = sub.index(STREAM)
        f = frames[j]
        yuv = f.yuv.clone()
        if fault == "alter":
            yuv[yuv.numel() // 2] ^= 1
        elif fault == "unchanged":
            if not first:
                first.append(yuv)
            yuv = first[0].clone()
        else:
            raise ValueError(fault)
        frames[j] = TorchFrame(yuv, f.dev_y.shape[1], f.dev_y.shape[0])
        return frames

    S._round_step = faulty


if __name__ == "__main__":
    plant(sys.argv[1])
    sys.exit(lockstep_client.main())

"""A client whose decoder offers a fake ``trace_snapshot``, for the test
that the program's counters reach the run as the window's deltas:

    python3 -m portbench.tests.snapshot_client

Its counters: ``snapshots``, the calls so far; ``nal_units``, the
``decode_nal`` calls so far; ``made``, 1. Each call returns one span
that ended just before it."""

from __future__ import annotations

import sys
import threading
import time

from broadway_tpu_torch.core import decoder as D

from portbench import client


def plant() -> None:
    decode_nal = D.Decoder.decode_nal

    def counting(self, nal):
        self.fake_nal_units = getattr(self, "fake_nal_units", 0) + 1
        return decode_nal(self, nal)

    def trace_snapshot(self):
        self.fake_snapshots = getattr(self, "fake_snapshots", 0) + 1
        now = time.time_ns()
        return {"counters": {"snapshots": self.fake_snapshots,
                             "nal_units": getattr(self, "fake_nal_units", 0),
                             "made": 1},
                "spans": [["fake", threading.current_thread().name,
                           now - 1000, now]]}

    D.Decoder.decode_nal = counting
    D.Decoder.trace_snapshot = trace_snapshot


if __name__ == "__main__":
    plant()
    sys.exit(client.main())

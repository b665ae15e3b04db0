"""round_batch: the mean B, in pictures, of the batched steps of the
window's lockstep calls (the lockstep clients' ``batches``, from
``decode_streams_lockstep``'s ``stats``): the group's size where every
round holds all its streams; lower where a round splits by its picture
parameters (constrained intra, chroma QP offset) or streams leave. None
where no client ran a lockstep group."""

from __future__ import annotations

UNIT = "pictures"


def read(run: dict):
    steps = [b for r in run["clients"] for b in r.get("batches", ())]
    if not steps:
        return None
    return sum(steps) / len(steps)

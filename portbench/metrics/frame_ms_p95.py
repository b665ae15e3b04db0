"""frame_ms_p95: the 95th percentile, over every picture of every
client fed and completed inside the window, of the time from the
picture's first NAL unit handed to ``decode_nal`` to its completion
event, in ms. It holds the DPB's output delay (a picture is put out
when the DPB bumps it) and every host stall."""

from __future__ import annotations

import numpy as np

UNIT = "ms"


def read(run: dict):
    lat = [1e3 * (d - a) for r in run["clients"]
           for _, _, a, _, _, d in r["pictures"]
           if d is not None and a >= 0.0 and d <= run["seconds"]]
    if not lat:
        return None
    return float(np.percentile(lat, 95))

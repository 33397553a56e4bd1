"""95th percentile, over every image released in the window, of the time
from the image's due release to its pipe line (open loop: a late release
counts against the system, as a user sees it).  An image without a line
has no latency: the comparison counts it as missing."""

import numpy as np


def read(run):
    arrival = {int(p["file-number"]): t for t, p in run.lines}
    lat = [arrival[i] - due for i, due in run.due.items() if i in arrival]
    if not lat:
        return None
    return float(np.percentile(np.asarray(lat) * 1e3, 95))

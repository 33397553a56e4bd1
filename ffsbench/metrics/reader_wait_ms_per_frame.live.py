"""The CLI's own count of the time its reader waited for images to appear
(its "Total time waiting for images to appear" line), over the frames it
processed: the poll that a live frame meets before anything looks at it."""

import re

WAIT = re.compile(r"Total time waiting for images to appear: ([0-9.]+) (ms|s)")


def read(run):
    m = WAIT.search(run.cli_stdout)
    if not m or not run.frames:
        return None
    ms = float(m.group(1)) * (1e3 if m.group(2) == "s" else 1.0)
    return ms / run.frames

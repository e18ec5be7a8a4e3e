"""95th percentile, over every chunk of the window, of the time from the
stream accepting the chunk into its queue to the writer receiving its
frames. The stream's loop is closed, so this is about the queue's length
in chunk periods: a reading of the stream driver, not a latency that a
user of an offline file sees."""

import numpy as np

MERGE = "max"


def read(run):
    lat = run.stamps.get("latency_ms")
    return float(np.percentile(lat, 95)) if lat else None

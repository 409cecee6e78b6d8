"""The 95th percentile over the window's batches of the milliseconds from
handing a batch's host frames to the engine until its host outputs
return (host clock); None under 20 batches."""

import numpy as np


def read(rec):
    lat = rec["window"]["batch_s"]
    return float(np.percentile(lat, 95)) * 1e3 if len(lat) >= 20 else None

"""95th percentile of every request's host time, from the call to its result, in ms."""
import numpy as np


def read(rec):
    return float(np.percentile(rec["durations"], 95)) * 1e3

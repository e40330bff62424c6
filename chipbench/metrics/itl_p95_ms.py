"""95th percentile of the gap between output tokens over every decode step
of the window, from ``DecodeServer.decode_step``'s own synchronised
timing, in ms."""
import numpy as np


def read(run):
    return float(np.percentile(run.itl_s, 95)) * 1e3

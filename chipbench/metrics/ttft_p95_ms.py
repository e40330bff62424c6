"""95th percentile of the time to first token over every request whose
batch started in the window: from the batch's start to its first token
(the prefill and its argmax, synchronised), in ms."""
import numpy as np


def read(run):
    return float(np.percentile(run.ttft_s, 95)) * 1e3

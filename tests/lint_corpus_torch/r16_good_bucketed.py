"""R16 good twin: the batch axis is rounded up to the power-of-two
bucket ladder before it reaches the CUDA-graph dispatch — mixed round sizes
reuse a handful of captured graphs."""

import numpy as np
import torch

MIN_BUCKET = 8


def model(data, lens, rems):
    return torch.sum(data, dim=1), lens, rems


def dispatch(items, width):
    fn = _CudaGraphFn(model)
    pad = MIN_BUCKET
    while pad < len(items):
        pad *= 2
    data = np.zeros((pad, width), np.uint8)
    lens = np.zeros(pad, np.int32)
    rems = np.zeros(pad, np.int32)
    return fn(data, lens, rems)

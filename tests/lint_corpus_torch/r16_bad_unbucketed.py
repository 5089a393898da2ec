"""R16 bad twin: a raw batch size feeds the CUDA-graph dispatch — every
distinct round size keys (and silently re-captures) a new graph,
outside the declared power-of-two bucket universe."""

import numpy as np
import torch


def model(data, lens, rems):
    return torch.sum(data, dim=1), lens, rems


def dispatch(items, width):
    fn = _CudaGraphFn(model)
    n = len(items)
    data = np.zeros((n, width), np.uint8)  # EXPECT[R16]
    lens = np.zeros(n, np.int32)
    rems = np.zeros(n, np.int32)
    return fn(data, lens, rems)

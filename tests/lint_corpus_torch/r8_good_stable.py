"""KNOWN-GOOD corpus for R8: pinned dtypes and full-axis selects — one
graph per shape, forever."""

import torch


# captured: see GRAPHS below
def score(data, lengths, width: int):
    scale = lengths.to(torch.float32) * float(width)
    bias = torch.tensor(0.5, dtype=torch.float32)
    fill = torch.where(lengths > 0, data, 0)
    return data * scale + bias + fill


# captured: see GRAPHS below
def gather(data, cols):
    return data[:, cols]


def caller(data):
    return gather(data, (0, 1, 2))


GRAPHS = [_CudaGraphFn(score), _CudaGraphFn(caller)]

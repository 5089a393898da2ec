"""KNOWN-BAD corpus: capture hazards in capture-reached code — a
host-read scalar, a dtype-less scalar tensor, boolean-mask indexing and
a data-dependent nonzero: each syncs or keys a new graph signature,
and a capture refuses a sync."""

import torch




# captured: see GRAPHS below
def score(data, lengths):
    scale = float(lengths)  # EXPECT[R8]
    bias = torch.tensor(0.5)  # EXPECT[R8]
    fill = data[lengths > 0]  # EXPECT[R8]
    return data * scale + bias + fill


# captured: see GRAPHS below
def gather(data, cols):
    return data[:, cols]


def caller(data):
    return gather(data, torch.nonzero(data))  # EXPECT[R8]


GRAPHS = [_CudaGraphFn(score), _CudaGraphFn(caller)]

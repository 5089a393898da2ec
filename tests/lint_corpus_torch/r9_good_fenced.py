"""KNOWN-GOOD corpus for R9: the captured function is pure torch; the
readback lives on the HOST side of the boundary (and dtype-scalar
constants on literals are device-free)."""

import numpy as np
import torch


# captured: see GRAPH below
def verdicts(data, lengths):
    mask = lengths.to(torch.int32) >= np.int32(0)
    return mask & (data[:, 0] > 0)


def readback(out):
    # The sanctioned sync point: one readback of the whole batch,
    # indexed on host.
    return out.cpu().numpy()


GRAPH = _CudaGraphFn(verdicts)

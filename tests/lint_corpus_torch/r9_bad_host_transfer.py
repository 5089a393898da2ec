"""KNOWN-BAD corpus: implicit host transfers inside captured code —
np coercion, .item(), synchronize on device values."""

import numpy as np
import torch


# captured: see GRAPH below
def verdicts(data, lengths):
    host = np.asarray(lengths)  # EXPECT[R9]
    first = lengths.item()  # EXPECT[R9]
    ready = torch.cuda.synchronize()  # EXPECT[R9]
    return host, first, ready


GRAPH = _CudaGraphFn(verdicts)

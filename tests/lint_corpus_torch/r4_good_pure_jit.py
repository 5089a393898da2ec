"""KNOWN-GOOD corpus for R4: pure capture-reached functions (including a
helper reached through the same-module call graph), and impure code
that is NOT capture-reached."""

import time

import torch


def _helper(x):
    return torch.tanh(x)


def forward(graph, x):
    with torch.cuda.graph(graph):
        return _helper(x) * 2


def eager_logger(x):
    # Impure, but never reached from a capture: fine.
    print("observed", time.time())
    return x

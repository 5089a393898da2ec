"""KNOWN-BAD corpus: impurity in capture-reached functions.  A CUDA
graph records the launches ONCE; mutations, locks, I/O and wall-clock
reads happen at capture time only (and wall-clock reads break
bit-identical verdicts across replicas)."""

import threading
import time

import torch


class Engine:
    def __init__(self):
        self.calls = 0
        self._mutex = threading.Lock()

    def _step(self, x):
        self.calls += 1  # EXPECT[R4]
        return x * 2

    def _guarded(self, x):
        with self._mutex:  # EXPECT[R4]
            return x + 1

    def compile(self):
        return _CudaGraphFn(self._step), self._jit_for({}, self, self._guarded)


def stamp(graph, x):
    with torch.cuda.graph(graph):
        return x + time.time()  # EXPECT[R4]

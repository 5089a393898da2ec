"""KNOWN-BAD corpus (R12, hot-path module name): table recompiles on
the dispatch path — the policy_update-in-handler bug shape.  One
compile reached from the round entry through a helper, one capture under
the registry lock."""

import threading

import torch

from models import build_table_model


class Service:
    def __init__(self):
        self._lock = threading.Lock()
        self._engines = {}

    def _process(self, items):
        for item in items:
            engine = self._ensure_engine(item.key)
            engine(item.data)

    def _ensure_engine(self, key):
        eng = self._engines.get(key)
        if eng is None:
            # Reached from _process: the round pays the whole trace.
            eng = build_table_model(key)  # EXPECT[R12] # EXPECT[R23]
            self._engines[key] = eng
        return eng

    def policy_update(self, policy):
        with self._lock:
            # Every snapshotting round queues behind this capture.
            fn = torch.cuda.CUDAGraph()  # EXPECT[R12]
            self._engines[policy.key] = fn
        return True

"""KNOWN-GOOD corpus (R12 twin): dispatch rounds only ever read
prebuilt engines; recompiles run on the builder thread and land by a
pointer flip under the lock (assignments only — no compile)."""

import threading

import torch

from models import build_table_model


class Service:
    def __init__(self):
        self._lock = threading.Lock()
        self._engines = {}
        self._build_queue = []

    def _process(self, items):
        with self._lock:
            engines = dict(self._engines)
        for item in items:
            eng = engines.get(item.key)
            if eng is None:
                item.fail_closed()
                continue
            eng(item.data)

    def policy_update(self, policy):
        # Stage only; the builder thread compiles off-path.
        self._build_queue.append(policy)
        return True

    def _policy_builder_loop(self):
        while self._build_queue:
            policy = self._build_queue.pop()
            eng = _CudaGraphFn(build_table_model(policy.key))
            # Builder compiles are ledgered (R23): the census is what
            # keeps warm-churn-is-zero-compiles an asserted invariant.
            self.ledger.record_compile("table", 0.0, cause="churn-new-shape")
            with self._lock:
                self._engines[policy.key] = eng

"""KNOWN-BAD corpus (R23, hot-path module name): executable-producing
sites reachable from the policy-builder roots that bypass the device
ledger — the compile census silently under-counts, so the churn soak's
"warm churn performs ZERO compiles" assertion goes vacuous for these
sites.  One capture in the builder loop, one mesh-model build in the
ladder walk, one prewarm on the rebind path."""

import torch

from models import build_table_model, mesh_table_model


class Service:
    def __init__(self):
        self._engines = {}
        self._build_queue = []

    def _policy_builder_loop(self):
        while self._build_queue:
            policy = self._build_queue.pop()
            # No record_compile, no cause_scope: un-censused capture.
            model = build_table_model(policy.key)  # EXPECT[R23]
            eng = torch.cuda.CUDAGraph()  # EXPECT[R23]
            self._engines[policy.key] = eng

    def _run_mesh_ladder(self, mesh):
        for key in list(self._engines):
            built = mesh_table_model(key, mesh)  # EXPECT[R23]
            self._engines[key] = built

    def _run_rebind(self, engine):
        engine.prewarm()  # EXPECT[R23]

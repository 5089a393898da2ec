"""KNOWN-GOOD corpus (R23 twin): the same builder/ladder/rebind
compile sites, each routed through the device ledger — the builder
loop records the compile with its cause, the ladder walk classifies
its rebuilds under a cause_scope, and the rebind path records through
the broadcast entry point."""

import torch

from cilium_tpu_torch.sidecar import ledger
from models import build_table_model, mesh_table_model


class Service:
    def __init__(self):
        self._engines = {}
        self._build_queue = []
        self.ledger = ledger.DeviceLedger()

    def _policy_builder_loop(self):
        while self._build_queue:
            policy = self._build_queue.pop()
            model = build_table_model(policy.key)
            eng = torch.cuda.CUDAGraph()
            self.ledger.record_compile(
                "table", 0.0, cause="churn-new-shape"
            )
            self._engines[policy.key] = eng

    def _run_mesh_ladder(self, mesh):
        with ledger.cause_scope(ledger.CAUSE_MESH_RESHAPE):
            for key in list(self._engines):
                built = mesh_table_model(key, mesh)
                self._engines[key] = built

    def _run_rebind(self, engine):
        engine.prewarm()
        ledger.broadcast_compile("table", 0.0, cause="heal-rebind")

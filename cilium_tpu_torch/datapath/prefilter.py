"""XDP prefilter analog: revisioned CIDR deny-lists compiled to device LPM.

reference: pkg/datapath/prefilter/prefilter.go — a pair of maps per
protocol (v4/v6), Insert/Delete guarded by a revision counter so
concurrent updates from stale readers are rejected; the datapath drops any
packet whose source address matches (bpf/bpf_xdp.c check_v4).

Counterpart of ``cilium_tpu/datapath/prefilter.py``: the deny lists
compile to the port's ``DeviceLpm`` on the filter's device, and
``filter_batch`` runs kernel K12 on the card and reads the drop mask back
once per batch.
"""

from __future__ import annotations

import ipaddress
import threading
from typing import Optional

import numpy as np

from ..device import resolve_device
from ..ops.lpm import DeviceLpm, build_lpm, prefilter_check_batch
from .pipeline import as_numpy


class PreFilter:
    """reference: prefilter.go:125 Insert / :162 Delete."""

    def __init__(self, device=None) -> None:
        """``device``: where the deny lists compile to and the batches
        run (None: the CUDA card; raises without one)."""
        self.device = resolve_device(device)
        self.revision = 1
        self._v4: set[str] = set()
        self._v6: set[str] = set()
        self._mutex = threading.RLock()
        self._device_v4: Optional[DeviceLpm] = None
        self._device_v6: Optional[DeviceLpm] = None
        self._dirty = True

    def insert(self, revision: int, cidrs: list[str]) -> int:
        """Returns the new revision; raises on stale revision
        (reference: prefilter.go revision check)."""
        with self._mutex:
            if revision != self.revision:
                raise ValueError(
                    f"stale prefilter revision {revision} != {self.revision}"
                )
            for c in cidrs:
                net = ipaddress.ip_network(c, strict=False)
                (self._v4 if net.version == 4 else self._v6).add(str(net))
            self.revision += 1
            self._dirty = True
            return self.revision

    def delete(self, revision: int, cidrs: list[str]) -> int:
        with self._mutex:
            if revision != self.revision:
                raise ValueError(
                    f"stale prefilter revision {revision} != {self.revision}"
                )
            for c in cidrs:
                net = ipaddress.ip_network(c, strict=False)
                target = self._v4 if net.version == 4 else self._v6
                if str(net) not in target:
                    raise KeyError(f"CIDR {net} not in prefilter")
            for c in cidrs:
                net = ipaddress.ip_network(c, strict=False)
                (self._v4 if net.version == 4 else self._v6).discard(str(net))
            self.revision += 1
            self._dirty = True
            return self.revision

    def dump(self) -> tuple[int, list[str]]:
        """reference: prefilter.go Dump — (revision, cidrs)."""
        with self._mutex:
            return self.revision, sorted(self._v4) + sorted(self._v6)

    def device_lpm(self, v6: bool = False) -> DeviceLpm:
        """Compile (cached until dirty) the deny-list to the device LPM."""
        with self._mutex:
            if self._dirty:
                self._device_v4 = build_lpm(
                    [(c, 1) for c in sorted(self._v4)], v6=False,
                    device=self.device,
                )
                self._device_v6 = build_lpm(
                    [(c, 1) for c in sorted(self._v6)], v6=True,
                    device=self.device,
                )
                self._dirty = False
            return self._device_v6 if v6 else self._device_v4

    def filter_batch(self, saddr, v6: bool = False, flowlog=None,
                     monitor=None) -> np.ndarray:
        """XDP source-drop pass over a batch (reference: bpf_xdp.c
        check_v4 — drop any packet whose source matches the deny LPM).
        ``saddr``: for v4 one [F] int32 word array, for v6 the four
        word arrays stacked [4, F] (numpy arrays or tensors).  Returns
        the [F] bool KEEP mask as a numpy array (one readback).

        Observability per BATCH, not per packet: drops land in the
        flow-record ring as one columnar round (path "xdp", match kind
        l3) and a bounded sample fans out as monitor drop events."""
        lpm = self.device_lpm(v6)
        words = [saddr[w] for w in range(4)] if v6 else [saddr]
        dropped = prefilter_check_batch(lpm, *words).cpu().numpy()
        keep = ~dropped
        idx = np.flatnonzero(dropped)
        if len(idx) and monitor is not None:
            for i in idx[:64]:  # perf-ring analog cap
                monitor.send_verdict(
                    src_identity=0, dst_identity=0, dport=0, proto=0,
                    allowed=False,
                )
        if len(idx) and flowlog is not None:
            from ..flowlog import CODE_DENIED, MATCH_L3, PATH_XDP

            cols = {
                "match_kind": [MATCH_L3] * len(idx),
                "src_addr_word": as_numpy(words[0])[idx].astype(np.int64),
            }
            flowlog.add_round(
                PATH_XDP,
                idx.astype(np.int64),  # batch row index as flow handle
                np.full(len(idx), CODE_DENIED, np.int8),
                reason="prefilter",
                cols=cols,
            )
        return keep

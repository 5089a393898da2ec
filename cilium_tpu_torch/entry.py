"""Port entry points: the r2d2 verdict step on the card, and the HTTP
verdict pass's policy and batch.

``bench_policy``, ``batch`` and ``entry`` are the counterparts of
``__graft_entry__._bench_policy``, ``_batch`` and ``entry()``
(``__graft_entry__.py:6-72``); ``http_bench_policy`` and ``http_batch``
are the port's copy of ``bench.py::bench_http``'s setup
(``bench.py:211-240``), built through NPDS.
"""

from __future__ import annotations

import random

import numpy as np
import torch

from .device import resolve_device
from .models.r2d2 import build_r2d2_model, r2d2_verdicts
from .proxylib import (
    NetworkPolicy,
    PolicyInstance,
    PortNetworkPolicy,
    PortNetworkPolicyRule,
    compile_policy,
)


def bench_policy() -> PolicyInstance:
    """The graft r2d2 policy: port 80 allows ``READ /public/.*`` and
    ``HALT``."""
    return compile_policy(
        NetworkPolicy(
            name="graft",
            policy=2,
            ingress_per_port_policies=[
                PortNetworkPolicy(
                    port=80,
                    rules=[
                        PortNetworkPolicyRule(
                            l7_proto="r2d2",
                            l7_rules=[
                                {"cmd": "READ", "file": "/public/.*"},
                                {"cmd": "HALT"},
                            ],
                        )
                    ],
                )
            ],
        )
    )


def batch(f: int, l: int = 64):
    """(data [f, l] uint8, lengths [f] int32, remotes [f] int32) numpy
    arrays cycling the graft's four messages."""
    msgs = [b"READ /public/a.txt\r\n", b"WRITE /x\r\n", b"HALT\r\n", b"READ /private/b\r\n"]
    data = np.zeros((f, l), dtype=np.uint8)
    lengths = np.zeros((f,), dtype=np.int32)
    for i in range(f):
        m = msgs[i % len(msgs)]
        data[i, : len(m)] = np.frombuffer(m, dtype=np.uint8)
        lengths[i] = len(m)
    remotes = np.ones((f,), dtype=np.int32)
    return data, lengths, remotes


def entry(device=None):
    """(fn, args): the forward step of the flagship model — the r2d2 L7
    verdict pipeline (frame -> tokenize -> automaton -> verdict) — with
    its example batch as tensors on ``device`` (None: the CUDA card,
    raising when there is none)."""
    device = resolve_device(device)
    model = build_r2d2_model(bench_policy(), ingress=True, port=80, device=device)
    args = tuple(torch.from_numpy(a).to(device) for a in batch(256))

    def fn(data, lengths, remotes):
        return r2d2_verdicts(model, data, lengths, remotes)

    return fn, args


def http_bench_policy() -> PolicyInstance:
    """The graft HTTP policy: port 80 allows ``GET /public/.*`` from any
    remote (``bench.py:211-214``)."""
    return compile_policy(
        NetworkPolicy(
            name="http-graft",
            policy=2,
            ingress_per_port_policies=[
                PortNetworkPolicy(
                    port=80,
                    rules=[
                        PortNetworkPolicyRule(
                            http_rules=[{"method": "GET", "path": "/public/.*"}],
                        )
                    ],
                )
            ],
        )
    )


def http_requests(n: int = 1024) -> list[bytes]:
    """``bench.py:216-228``'s request mix from ``random.Random(11)``: half
    under /public/, a fifth POST, each with Host and User-Agent headers."""
    rng = random.Random(11)
    reqs = []
    for _ in range(n):
        roll = rng.random()
        path = (
            f"/public/a{rng.randrange(1000)}" if roll < 0.5
            else f"/private/b{rng.randrange(1000)}"
        )
        method = "GET" if rng.random() < 0.8 else "POST"
        reqs.append(
            f"{method} {path} HTTP/1.1\r\nHost: svc.local\r\n"
            f"User-Agent: bench\r\n\r\n".encode()
        )
    return reqs


def http_batch(f: int, l: int = 512):
    """(data [f, l] uint8, lengths [f] int32, remotes [f] int32) numpy
    arrays cycling ``http_requests()`` (``bench.py:233-240``)."""
    reqs = http_requests()
    data = np.zeros((f, l), np.uint8)
    lengths = np.zeros((f,), np.int32)
    for i in range(f):
        r = reqs[i % len(reqs)][:l]
        data[i, : len(r)] = np.frombuffer(r, np.uint8)
        lengths[i] = len(r)
    remotes = np.ones((f,), np.int32)
    return data, lengths, remotes

"""Kafka batch verdict model: topic ACLs as one device pass.

Counterpart of ``cilium_tpu/models/kafka.py``.  Replaces the reference's
per-request rule walk (reference: pkg/kafka/policy.go:200 MatchesRule over
[]PortRuleKafka) with a batched evaluation over [F] parsed request headers
and [F, T] topic lists:

  base[f, r]   = api-key-mask ∧ version ∧ clientID/nil-request handling
                 ∧ remote set
  simple[f]    = ∃r: (rule topic empty ∨ no topics) ∧ base
  cover[f, t]  = ∃r: rule topic == topic[f, t] ∧ base
  allowed[f]   = (simple ∨ (topics present ∧ ∀t cover)) ∧ ¬overflow

Requests are parsed on the host (``kafka/request.py``: the wire format is
variable-length and branchy) into fixed-shape arrays by
``encode_requests``; the rule matching runs on the device.  On the card
the whole of it (``kafka_rule_hits`` and ``kafka_combine`` fused) is
kernel K17 ``kafka_hits``; ``kafka_verdicts_plain`` is its plain version.
``kafka_rule_hits`` and ``kafka_combine`` stay separate functions with
the reference's outputs, so a rule-sharded step can all-reduce
``simple`` / ``cover`` between them.  The host compile and the encoder
are copies of the reference's.  Bit-identical to the host oracle
(``kafka.policy.matches_rule``), fuzz-checked in the tests.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, fields

import numpy as np
import torch

from .. import kernels
from ..device import as_tensor, resolve_device
from ..kafka.request import (
    FIND_COORDINATOR_KEY,
    PARSED_TOPIC_KEYS,
    RequestMessage,
    TOPIC_API_KEYS,
)
from ..policy.api import PortRuleKafka
from .base import MAX_REMOTES, ConstVerdict, VerdictModel, pack_remote_sets, remote_ok

MAX_API_KEY = 64
MAX_TOPICS = 8  # topics per request tensor; overflowing requests are
# flagged and must be decided by the host oracle (fail closed on device)
MAX_TOPIC_LEN = 256  # Kafka topics are <= 249 chars (api/kafka.go:238)
MAX_CLIENT_LEN = 64

_KAFKA_HITS = kernels.CudaKernel(
    "kafka_hits", "kafka_hits",
    [ctypes.c_void_p] * 22 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3,
)


@dataclass
class KafkaBatchModel(VerdictModel):
    api_key_mask: torch.Tensor  # [R, MAX_API_KEY] bool
    version: torch.Tensor  # [R] int32
    version_any: torch.Tensor  # [R] bool
    client: torch.Tensor  # [R, MAX_CLIENT_LEN] uint8
    client_len: torch.Tensor  # [R] int32
    client_any: torch.Tensor  # [R] bool
    topic: torch.Tensor  # [R, MAX_TOPIC_LEN] uint8
    topic_len: torch.Tensor  # [R] int32
    topic_any: torch.Tensor  # [R] bool
    is_topic_key: torch.Tensor  # [MAX_API_KEY] bool
    remote_ids: torch.Tensor  # [R, MAX_REMOTES] int32
    any_remote: torch.Tensor  # [R] bool

    def __post_init__(self):
        # K17 reads these tables as they are: check them once, here.
        device = self.device
        chk = kernels.check
        chk(self.version, "version", torch.int32, (None,), device)
        r = self.version.shape[0]
        chk(self.api_key_mask, "api_key_mask", torch.bool, (r, MAX_API_KEY), device)
        chk(self.version_any, "version_any", torch.bool, (r,), device)
        chk(self.client, "client", torch.uint8, (r, MAX_CLIENT_LEN), device)
        chk(self.client_len, "client_len", torch.int32, (r,), device)
        chk(self.client_any, "client_any", torch.bool, (r,), device)
        chk(self.topic, "topic", torch.uint8, (r, MAX_TOPIC_LEN), device)
        chk(self.topic_len, "topic_len", torch.int32, (r,), device)
        chk(self.topic_any, "topic_any", torch.bool, (r,), device)
        chk(self.is_topic_key, "is_topic_key", torch.bool, (MAX_API_KEY,), device)
        chk(self.remote_ids, "remote_ids", torch.int32, (r, MAX_REMOTES), device)
        chk(self.any_remote, "any_remote", torch.bool, (r,), device)

    @property
    def device(self) -> torch.device:
        return self.version.device

    @property
    def n_rules(self) -> int:
        return self.version.shape[0]

    def __call__(self, batch, remotes):
        return kafka_verdicts(self, batch, remotes)


def _pad_bytes(s: str, width: int) -> tuple[np.ndarray, int]:
    b = s.encode()[:width]
    out = np.zeros((width,), np.uint8)
    out[: len(b)] = np.frombuffer(b, np.uint8)
    return out, len(b)


def build_kafka_model(
    rules_with_remotes: list[tuple[frozenset, PortRuleKafka]], device=None,
) -> KafkaBatchModel | ConstVerdict:
    """Compile (allowed_remote_set, rule) rows into tables on ``device``
    (None: the CUDA card).  Rules must be sanitized (role expansion done,
    reference: api/kafka.go Sanitize)."""
    device = resolve_device(device)
    if not rules_with_remotes:
        return ConstVerdict(False)
    n = len(rules_with_remotes)
    api_key_mask = np.zeros((n, MAX_API_KEY), bool)
    version = np.zeros((n,), np.int32)
    version_any = np.zeros((n,), bool)
    client = np.zeros((n, MAX_CLIENT_LEN), np.uint8)
    client_len = np.zeros((n,), np.int32)
    client_any = np.zeros((n,), bool)
    topic = np.zeros((n, MAX_TOPIC_LEN), np.uint8)
    topic_len = np.zeros((n,), np.int32)
    topic_any = np.zeros((n,), bool)

    for i, (_, r) in enumerate(rules_with_remotes):
        if len(r.topic.encode()) > MAX_TOPIC_LEN:
            raise ValueError(f"rule topic exceeds {MAX_TOPIC_LEN} bytes")
        if len(r.client_id.encode()) > MAX_CLIENT_LEN:
            raise ValueError(f"rule clientID exceeds {MAX_CLIENT_LEN} bytes")
        if r.api_keys_int:
            for k in r.api_keys_int:
                if 0 <= k < MAX_API_KEY:
                    api_key_mask[i, k] = True
        else:
            api_key_mask[i, :] = True  # wildcard (CheckAPIKeyRole)
        v, wildcard = r.get_api_version()
        version[i] = v
        version_any[i] = wildcard
        client[i], client_len[i] = _pad_bytes(r.client_id, MAX_CLIENT_LEN)
        client_any[i] = r.client_id == ""
        topic[i], topic_len[i] = _pad_bytes(r.topic, MAX_TOPIC_LEN)
        topic_any[i] = r.topic == ""

    is_topic_key = np.zeros((MAX_API_KEY,), bool)
    for k in TOPIC_API_KEYS:
        if k < MAX_API_KEY:
            is_topic_key[k] = True

    packed_ids, any_remote = pack_remote_sets(
        [rs for rs, _ in rules_with_remotes]
    )

    def up(a):
        return torch.from_numpy(a).to(device)

    return KafkaBatchModel(
        api_key_mask=up(api_key_mask),
        version=up(version),
        version_any=up(version_any),
        client=up(client),
        client_len=up(client_len),
        client_any=up(client_any),
        topic=up(topic),
        topic_len=up(topic_len),
        topic_any=up(topic_any),
        is_topic_key=up(is_topic_key),
        remote_ids=up(packed_ids),
        any_remote=up(any_remote),
    )


@dataclass
class KafkaRequestBatch:
    """Fixed-shape encoding of F parsed requests: numpy arrays from
    ``encode_requests``, or tensors on one device (``to_device``)."""

    api_key: np.ndarray  # [F] int32
    api_version: np.ndarray  # [F] int32
    client: np.ndarray  # [F, MAX_CLIENT_LEN] uint8
    client_len: np.ndarray  # [F] int32
    topics: np.ndarray  # [F, MAX_TOPICS, topic width] uint8
    topic_len: np.ndarray  # [F, MAX_TOPICS] int32
    topic_count: np.ndarray  # [F] int32
    parsed: np.ndarray  # [F] bool
    overflow: np.ndarray  # [F] bool — exceeds tensor limits; host decides

    def to_device(self, device) -> "KafkaRequestBatch":
        """The same batch as contiguous tensors on ``device``."""
        return KafkaRequestBatch(**{
            f.name: as_tensor(getattr(self, f.name), _BATCH_DTYPES[f.name], device)
            for f in fields(self)
        })


_BATCH_DTYPES = {
    "api_key": torch.int32, "api_version": torch.int32, "client": torch.uint8,
    "client_len": torch.int32, "topics": torch.uint8, "topic_len": torch.int32,
    "topic_count": torch.int32, "parsed": torch.bool, "overflow": torch.bool,
}


def encode_requests(
    reqs: list[RequestMessage], topic_width: int | None = None
) -> KafkaRequestBatch:
    """Host-side tensorization of parsed requests; deduplicates topics
    (MatchesRule's map semantics — reference: policy.go:204-208).
    Requests exceeding the tensor limits are flagged ``overflow``: the
    device denies them and the caller re-evaluates with the host oracle
    (``kafka.policy.matches_rule``) — never a silent truncation.

    The topic tensor width auto-sizes to the batch's longest name,
    rounded up to a power-of-two bucket (min 32): real topic names are
    tens of bytes, and [F, T, 256] mostly-padding arrays would make the
    batch's transfer the larger part of a pass."""
    f = len(reqs)
    if topic_width is not None and topic_width > MAX_TOPIC_LEN:
        raise ValueError(f"topic_width exceeds {MAX_TOPIC_LEN}")
    if topic_width is None:
        longest = max(
            (len(t.encode()) for r in reqs for t in r.get_topics()),
            default=1,
        )
        topic_width = 32
        while topic_width < min(longest, MAX_TOPIC_LEN):
            topic_width *= 2
    batch = KafkaRequestBatch(
        api_key=np.zeros((f,), np.int32),
        api_version=np.zeros((f,), np.int32),
        client=np.zeros((f, MAX_CLIENT_LEN), np.uint8),
        client_len=np.zeros((f,), np.int32),
        topics=np.zeros((f, MAX_TOPICS, topic_width), np.uint8),
        topic_len=np.zeros((f, MAX_TOPICS), np.int32),
        topic_count=np.zeros((f,), np.int32),
        parsed=np.zeros((f,), bool),
        overflow=np.zeros((f,), bool),
    )
    for i, r in enumerate(reqs):
        batch.api_key[i] = r.api_key
        batch.api_version[i] = r.api_version
        distinct = list(dict.fromkeys(r.get_topics()))
        if (len(distinct) > MAX_TOPICS
                or not 0 <= r.api_key < MAX_API_KEY
                or len(r.client_id.encode()) > MAX_CLIENT_LEN
                or any(len(t.encode()) > topic_width for t in distinct)):
            batch.overflow[i] = True
            continue
        batch.client[i], batch.client_len[i] = _pad_bytes(
            r.client_id, MAX_CLIENT_LEN
        )
        batch.topic_count[i] = len(distinct)
        for t, name in enumerate(distinct):
            batch.topics[i, t], batch.topic_len[i, t] = _pad_bytes(
                name, topic_width
            )
        batch.parsed[i] = r.parsed and r.api_key in PARSED_TOPIC_KEYS
    return batch


# --- kernel K17: the topic ACL ------------------------------------------------


def kafka_rule_hits(
    model: KafkaBatchModel, batch: KafkaRequestBatch, remotes: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-rule-set partial reductions, plain PyTorch on a batch of
    tensors: (simple [F] bool, cover [F, T] bool)
    (``cilium_tpu/models/kafka.py:229-299``).  These OR across disjoint
    rule subsets, so a rule-sharded step all-reduces them before the
    final combine (``kafka_combine``); the combine itself (∀topics) does
    NOT distribute over rule subsets."""
    b = batch
    key_clamped = b.api_key.clamp(0, MAX_API_KEY - 1).long()
    in_range = (b.api_key >= 0) & (b.api_key < MAX_API_KEY)

    # [F, R] api-key role + version gates (policy.go:152-159).
    key_ok = model.api_key_mask.T[key_clamped] & in_range[:, None]
    ver_ok = model.version_any[None, :] | (
        model.version[None, :] == b.api_version[:, None]
    )

    # clientID equality [F, R]: lengths equal and padded bytes equal.
    client_eq = (b.client_len[:, None] == model.client_len[None, :]) & (
        b.client[:, None, :] == model.client[None, :, :]
    ).all(dim=-1)

    # Per-request-type extra gate (ruleMatches switch, policy.go:161-195).
    simple_rule = (model.topic_any & model.client_any)[None, :]
    is_fc = (b.api_key == FIND_COORDINATOR_KEY)[:, None]
    nil_topic_reject = (~model.topic_any[None, :]) & (
        model.is_topic_key[key_clamped] & in_range
    )[:, None]
    extra = torch.where(
        simple_rule,
        simple_rule,
        torch.where(
            b.parsed[:, None],
            model.client_any[None, :] | client_eq,
            is_fc | ~nil_topic_reject,
        ),
    )

    rok = remote_ok(remotes, model.remote_ids, model.any_remote)  # [F, R]
    base = key_ok & ver_ok & extra & rok  # [F, R]

    # First branch: topic-less rule OR topic-less request (policy.go:210).
    simple = (
        base & (model.topic_any[None, :] | (b.topic_count == 0)[:, None])
    ).any(dim=1)

    # Topic coverage: [F, T, R] exact compares.  The rule topic tensor is
    # stored at MAX_TOPIC_LEN but the batch auto-sizes its width (see
    # encode_requests); slice the rule tensor down to the batch width.
    # Bit-identical: batch topic lengths are always <= width, so a rule
    # with topic_len > width already fails the length-equality gate, and
    # for rules with topic_len <= width every meaningful byte lies inside
    # the slice (both tensors are zero-padded past their length).
    rule_topic = model.topic[:, : b.topics.shape[-1]]
    t_eq = (b.topic_len[:, :, None] == model.topic_len[None, None, :]) & (
        b.topics[:, :, None, :] == rule_topic[None, None, :, :]
    ).all(dim=-1)
    cover = (
        t_eq & (~model.topic_any)[None, None, :] & base[:, None, :]
    ).any(dim=2)  # [F, T]
    return simple, cover


def kafka_combine(
    simple: torch.Tensor,  # [F] bool — ORed across rule subsets
    cover: torch.Tensor,  # [F, T] bool — ORed across rule subsets
    topic_count: torch.Tensor,  # [F] int32
    overflow: torch.Tensor,  # [F] bool
) -> torch.Tensor:
    """Final verdict from (possibly all-reduced) partial reductions
    (``cilium_tpu/models/kafka.py:302-314``)."""
    t_idx = torch.arange(cover.shape[1], device=cover.device)[None, :]
    active = t_idx < topic_count[:, None]
    all_covered = (cover | ~active).all(dim=1) & (topic_count > 0)
    # Overflowed requests are denied on device; the engine re-evaluates
    # them with the host oracle.
    return (simple | all_covered) & ~overflow


def kafka_verdicts_plain(
    model: KafkaBatchModel, batch: KafkaRequestBatch, remotes: torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch version of K17: allowed [F] bool."""
    simple, cover = kafka_rule_hits(model, batch, remotes)
    return kafka_combine(simple, cover, batch.topic_count, batch.overflow)


def kafka_hits(
    model: KafkaBatchModel, batch: KafkaRequestBatch, remotes: torch.Tensor,
    parts: bool = False,
):
    """K17: allowed [F] bool for a batch of tensors on the model's device;
    with ``parts``, (allowed, simple [F], cover [F, T]) — the outputs of
    ``kafka_rule_hits`` beside the combined verdict."""
    device = model.device
    b = batch
    kernels.check(b.api_key, "api_key", torch.int32, (None,), device)
    f = b.api_key.shape[0]
    kernels.check(b.topics, "topics", torch.uint8, (f, MAX_TOPICS, None), device)
    w = b.topics.shape[2]
    if not 0 < w <= MAX_TOPIC_LEN:
        raise ValueError(f"topics: width {w} not in [1, {MAX_TOPIC_LEN}]")
    for name in ("api_version", "client_len", "topic_count"):
        kernels.check(getattr(b, name), name, torch.int32, (f,), device)
    kernels.check(b.client, "client", torch.uint8, (f, MAX_CLIENT_LEN), device)
    kernels.check(b.topic_len, "topic_len", torch.int32, (f, MAX_TOPICS), device)
    kernels.check(b.parsed, "parsed", torch.bool, (f,), device)
    kernels.check(b.overflow, "overflow", torch.bool, (f,), device)
    kernels.check(remotes, "remotes", torch.int32, (f,), device)
    if kernels.on_cpu(device):
        simple, cover = kafka_rule_hits(model, b, remotes)
        allow = kafka_combine(simple, cover, b.topic_count, b.overflow)
        return (allow, simple, cover) if parts else allow
    allow = torch.empty((f,), dtype=torch.bool, device=device)
    simple = cover = None
    if parts:
        simple = torch.empty((f,), dtype=torch.bool, device=device)
        cover = torch.empty((f, MAX_TOPICS), dtype=torch.bool, device=device)
    if f:
        p = kernels.p
        null = ctypes.c_void_p(None)
        m = model
        _KAFKA_HITS.launch(
            device, p(b.api_key), p(b.api_version), p(b.client), p(b.client_len),
            p(b.topics), p(b.topic_len), p(b.topic_count), p(b.parsed),
            p(b.overflow), p(remotes),
            p(m.api_key_mask), p(m.version), p(m.version_any), p(m.client),
            p(m.client_len), p(m.client_any), p(m.topic), p(m.topic_len),
            p(m.topic_any), p(m.is_topic_key), p(m.remote_ids), p(m.any_remote),
            f, m.n_rules, MAX_TOPICS, w,
            p(allow), null if simple is None else p(simple),
            null if cover is None else p(cover),
        )
    return (allow, simple, cover) if parts else allow


def kafka_verdicts(model: KafkaBatchModel, batch: KafkaRequestBatch, remotes) -> torch.Tensor:
    """Returns allowed [F] bool on the model's device; bit-identical to
    ``matches_rule``.  The batch's arrays and ``remotes`` may be numpy
    arrays or tensors."""
    device = model.device
    return kafka_hits(
        model, batch.to_device(device), as_tensor(remotes, torch.int32, device)
    )

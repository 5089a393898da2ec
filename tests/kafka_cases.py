"""Boundary tables and batches for K17 ``kafka_hits`` (no JAX: the card
tests and ``chip_hits_variants.py`` import it too).

``kafka_tables(r, w)`` is a seeded numpy rule table of r rows in
``KafkaBatchModel``'s layout and ``kafka_batch(tables, f, w)`` a seeded
request batch of f rows in ``KafkaRequestBatch``'s layout (T = 8 topic
slots of w bytes), both zero-padded past every length as
``build_kafka_model`` and ``encode_requests`` pad them.  The tables cycle
through every kind of row the walk could get wrong:

- simple rows (any topic and client), rows with a topic, a client id, or
  both, rows of one api key (0, 10, 63) or none, exact and any versions;
- client ids of 0 and 64 bytes and ones equal to the batch's up to their
  last byte; topics of 1 to 249 bytes, equal to the batch's up to their
  last byte, and longer than the width (w = 32);
- remote sets of 1 id (padded with itself), of 32 distinct ids, padded
  with -1, and any-remote rows.

The batches put api keys -1, 0, 10, 63, 64 and 70, versions 0-3, parsed
and unparsed rows, client lengths 0, 64 and the tables' lengths, 0 to 9
topics (over 8: overflow, the first 8 kept), topics equal to a rule's up
to the last byte, inactive slots that hold nothing, and remotes -1, 0, the
tables' ids and unknown ones.  ``R_SIZES`` and ``W_SIZES`` are the table
sizes and widths the tests take.
"""

from __future__ import annotations

import numpy as np
import torch

MAX_API_KEY = 64
MAX_CLIENT = 64
MAX_TOPIC_LEN = 256
MAX_TOPICS = 8
MAX_REMOTES = 32
R_SIZES = (1, 2, 31, 33, 130)
W_SIZES = (32, 256)
F_SIZES = (1, 37, 2048, 4099)
KEYS = (-1, 0, 1, 3, 10, 63, 64, 70)
# policy/api.py's KAFKA_TOPIC_API_KEYS, the table the nil-topic gate reads
TOPIC_KEYS = (0, 1, 2, 3, 4, 5, 6, 8, 9, 19, 20, 21, 23, 24, 27, 28, 34, 35, 37)
TOPICS = (b"a", b"events", b"events-2024", b"allowed-topic", b"x" * 31, b"x" * 32, b"y" * 33,
          b"z" * 63, b"w" * 249)
CLIENTS = (b"", b"bench", b"producer-1", b"consumer-1", b"c" * 63, b"c" * 64)
TABLE_KINDS = ("simple", "topic", "client", "topic+client", "version", "key10", "key63",
               "nokey", "near-topic", "long-topic", "near-client")
REMOTES = (-1, 0, 1, 2, 3, 5, 7, 9, 1000)


def _near(b: bytes) -> bytes:
    """b with its last byte changed (equal up to the last byte)."""
    return b[:-1] + bytes([b[-1] ^ 1]) if b else b"q"


def _pad(b: bytes, width: int) -> np.ndarray:
    out = np.zeros(width, np.uint8)
    out[: len(b)] = np.frombuffer(b[:width], np.uint8)
    return out


def _ids(rng, kind: str) -> tuple[np.ndarray, bool]:
    if kind == "any":
        return np.zeros(MAX_REMOTES, np.int32), True
    if kind == "one":
        return np.full(MAX_REMOTES, int(rng.choice([0, 1, 2, 3, 7])), np.int32), False
    if kind == "many":  # 32 distinct ids in no order, 0 and 5 among them
        ids = np.concatenate([[0, 5], rng.choice(np.arange(8, 4000), MAX_REMOTES - 2, replace=False)])
        return rng.permutation(ids).astype(np.int32), False
    ids = np.full(MAX_REMOTES, -1, np.int32)
    ids[:3] = rng.permutation([3, 1, 2])
    return ids, False


def kafka_tables(r: int, w: int = 32, seed: int = 0) -> dict:
    """The rule tables of ``KafkaBatchModel`` for r rows, the kinds of
    ``TABLE_KINDS`` in turn."""
    rng = np.random.default_rng(3000 + r + w + seed)
    t = dict(
        api_key_mask=np.zeros((r, MAX_API_KEY), bool), version=np.zeros(r, np.int32),
        version_any=np.ones(r, bool), client=np.zeros((r, MAX_CLIENT), np.uint8),
        client_len=np.zeros(r, np.int32), client_any=np.ones(r, bool),
        topic=np.zeros((r, MAX_TOPIC_LEN), np.uint8), topic_len=np.zeros(r, np.int32),
        topic_any=np.ones(r, bool), is_topic_key=np.zeros(MAX_API_KEY, bool),
        remote_ids=np.zeros((r, MAX_REMOTES), np.int32), any_remote=np.zeros(r, bool),
    )
    t["is_topic_key"][list(TOPIC_KEYS)] = True
    for i in range(r):
        kind = TABLE_KINDS[(i + seed) % len(TABLE_KINDS)]
        keys = rng.choice(MAX_API_KEY, size=int(rng.integers(1, 6)), replace=False)
        t["api_key_mask"][i, keys] = True
        t["api_key_mask"][i, [0, 1]] = rng.random() < 0.8  # produce / fetch mostly
        topic = client = None
        if kind in ("topic", "topic+client", "version"):
            topic = TOPICS[int(rng.integers(0, len(TOPICS) - (1 if w < 249 else 0)))]
        if kind in ("client", "topic+client"):
            client = CLIENTS[int(rng.integers(0, len(CLIENTS)))]
        if kind == "version":
            t["version_any"][i] = False
            t["version"][i] = int(rng.integers(0, 3))
        elif kind == "key10":
            t["api_key_mask"][i] = False
            t["api_key_mask"][i, 10] = True
        elif kind == "key63":
            t["api_key_mask"][i] = False
            t["api_key_mask"][i, 63] = True
            topic = TOPICS[1]
        elif kind == "nokey":
            t["api_key_mask"][i] = False
        elif kind == "near-topic":
            topic = _near(TOPICS[int(rng.integers(1, 6))])
        elif kind == "long-topic":
            topic = b"L" * (w + 1 if w < MAX_TOPIC_LEN else 250)
        elif kind == "near-client":
            client = _near(CLIENTS[int(rng.integers(1, len(CLIENTS)))])
        if topic is not None:
            t["topic_any"][i] = False
            t["topic"][i] = _pad(topic, MAX_TOPIC_LEN)
            t["topic_len"][i] = len(topic)
        if client is not None:
            t["client_any"][i] = False
            t["client"][i] = _pad(client, MAX_CLIENT)
            t["client_len"][i] = len(client)
        rem = ("any", "one", "many", "few")[(i // 2 + seed) % 4]
        t["remote_ids"][i], t["any_remote"][i] = _ids(rng, rem)
    return t


def kafka_batch(tables: dict, f: int, w: int = 32, seed: int = 0) -> tuple[dict, np.ndarray]:
    """A request batch of f rows (``KafkaRequestBatch``'s arrays, T = 8
    slots of w bytes) and its remotes [f] int32."""
    r = tables["version"].shape[0]
    rng = np.random.default_rng(4000 + 7 * f + w + r + seed)
    rule_topics = [bytes(tables["topic"][i, : tables["topic_len"][i]]) for i in range(r)
                   if not tables["topic_any"][i] and tables["topic_len"][i] <= w]
    rule_clients = [bytes(tables["client"][i, : tables["client_len"][i]]) for i in range(r)
                    if not tables["client_any"][i]]
    topics_pool = [t for t in TOPICS if len(t) <= w] + rule_topics
    b = dict(
        api_key=rng.choice(KEYS, size=f).astype(np.int32),
        api_version=rng.integers(0, 4, size=f).astype(np.int32),
        client=np.zeros((f, MAX_CLIENT), np.uint8), client_len=np.zeros(f, np.int32),
        topics=np.zeros((f, MAX_TOPICS, w), np.uint8), topic_len=np.zeros((f, MAX_TOPICS), np.int32),
        topic_count=np.zeros(f, np.int32), parsed=rng.random(f) < 0.6, overflow=np.zeros(f, bool),
    )
    for i in range(f):
        roll = rng.random()
        pool = rule_clients if rule_clients and roll < 0.5 else list(CLIENTS)
        client = pool[int(rng.integers(0, len(pool)))]
        if rng.random() < 0.1:
            client = _near(client)
        b["client"][i] = _pad(client, MAX_CLIENT)
        b["client_len"][i] = len(client)
        n = int(rng.choice([0, 1, 1, 1, 2, 3, 5, 8, 9]))
        b["topic_count"][i] = n
        b["overflow"][i] = n > MAX_TOPICS
        names = []
        # some rows name only the rules' topics, so that every slot may be covered
        pool = rule_topics if rule_topics and rng.random() < 0.4 else topics_pool
        for _ in range(min(n, MAX_TOPICS)):
            name = pool[int(rng.integers(0, len(pool)))]
            if rng.random() < 0.1:
                name = _near(name)
            names.append(name)
        for s, name in enumerate(names):
            b["topics"][i, s] = _pad(name, w)
            b["topic_len"][i, s] = len(name)
    b["api_key"][: min(f, len(KEYS))] = KEYS[: min(f, len(KEYS))]
    remotes = rng.choice(REMOTES, size=f).astype(np.int32)
    many = tables["remote_ids"][~tables["any_remote"]].ravel()
    if many.size:
        pick = rng.random(f) < 0.3
        remotes[pick] = rng.choice(many, size=int(pick.sum()))
    return b, remotes


def kafka_model(tables: dict, device="cpu", offset: int = 0):
    """A ``KafkaBatchModel`` on ``device`` holding the tables as they are;
    each table ``offset`` elements into its storage."""
    from cilium_tpu_torch.models.kafka import KafkaBatchModel

    return KafkaBatchModel(**{k: at(device, v, offset) for k, v in tables.items()})


def request_batch(batch: dict, device="cpu", offset: int = 0):
    """The batch as a ``KafkaRequestBatch`` of tensors on ``device``, each
    ``offset`` elements into its storage."""
    from cilium_tpu_torch.models.kafka import KafkaRequestBatch

    return KafkaRequestBatch(**{k: at(device, v, offset) for k, v in batch.items()})


def at(dev, a: np.ndarray, offset: int = 0) -> torch.Tensor:
    """numpy ``a`` on ``dev``, ``offset`` elements into its storage (a base
    that no 16-byte load takes, for offset 1 of a byte array)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if not offset:
        return t.to(dev)
    view = torch.empty(t.numel() + offset, dtype=t.dtype, device=dev)[offset:].view(t.shape)
    view.copy_(t)
    return view

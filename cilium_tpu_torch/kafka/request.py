"""Kafka wire-format request parsing and response construction.

reference: pkg/kafka/request.go — the reference parses requests with the
optiopay/kafka library; here the header and the topic lists of the six
topic-bearing request types the reference inspects (produce, fetch,
offsets, metadata, offsetcommit, offsetfetch — request.go:88-156) are
parsed directly from the wire format:

  frame   := length(int32) header body
  header  := api_key(int16) api_version(int16) correlation_id(int32)
             client_id(nullable_string)
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Optional

# API keys (reference: pkg/policy/api/kafka.go:107-133).
PRODUCE_KEY = 0
FETCH_KEY = 1
OFFSETS_KEY = 2
METADATA_KEY = 3
OFFSET_COMMIT_KEY = 8
OFFSET_FETCH_KEY = 9
FIND_COORDINATOR_KEY = 10

# Request types whose topics the reference extracts (request.go:88).
PARSED_TOPIC_KEYS = frozenset(
    [PRODUCE_KEY, FETCH_KEY, OFFSETS_KEY, METADATA_KEY,
     OFFSET_COMMIT_KEY, OFFSET_FETCH_KEY]
)

# API keys carrying a topic in the request (reference: policy.go:27
# isTopicAPIKey) — single source of truth in policy.api.
from ..policy.api import KAFKA_TOPIC_API_KEYS as TOPIC_API_KEYS  # noqa: E402

ERROR_TOPIC_AUTHORIZATION_FAILED = 29


class KafkaParseError(ValueError):
    pass


class _Reader:
    def __init__(self, data: bytes) -> None:
        self.data = data
        self.off = 0

    def _need(self, n: int) -> None:
        if self.off + n > len(self.data):
            raise KafkaParseError(
                f"truncated at offset {self.off}, need {n} bytes"
            )

    def int8(self) -> int:
        self._need(1)
        v = self.data[self.off]
        self.off += 1
        return v

    def int16(self) -> int:
        self._need(2)
        v = struct.unpack_from(">h", self.data, self.off)[0]
        self.off += 2
        return v

    def int32(self) -> int:
        self._need(4)
        v = struct.unpack_from(">i", self.data, self.off)[0]
        self.off += 4
        return v

    def int64(self) -> int:
        self._need(8)
        v = struct.unpack_from(">q", self.data, self.off)[0]
        self.off += 8
        return v

    def string(self) -> Optional[str]:
        n = self.int16()
        if n < 0:
            return None
        self._need(n)
        v = self.data[self.off:self.off + n].decode("utf-8", "replace")
        self.off += n
        return v

    def bytes_(self) -> Optional[bytes]:
        n = self.int32()
        if n < 0:
            return None
        self._need(n)
        v = self.data[self.off:self.off + n]
        self.off += n
        return v

    def skip(self, n: int) -> None:
        self._need(n)
        self.off += n


@dataclass
class RequestMessage:
    """reference: pkg/kafka/request.go RequestMessage."""

    api_key: int
    api_version: int
    correlation_id: int
    client_id: str
    topics: list[str] = field(default_factory=list)
    parsed: bool = False  # body parsed (one of PARSED_TOPIC_KEYS)
    raw: bytes = b""  # full frame including the length prefix

    def get_topics(self) -> list[str]:
        return self.topics

    def set_correlation_id(self, cid: int) -> None:
        """Rewrite in the raw frame too (reference: request.go:66)."""
        self.correlation_id = cid
        if len(self.raw) >= 12:
            self.raw = (
                self.raw[:8] + struct.pack(">i", cid) + self.raw[12:]
            )

    def create_response(self, error_code: int = ERROR_TOPIC_AUTHORIZATION_FAILED
                        ) -> "ResponseMessage":
        """Build a deny response echoing the correlation ID
        (reference: request.go:158 CreateResponse)."""
        body = _error_response_body(self, error_code)
        payload = struct.pack(">i", self.correlation_id) + body
        return ResponseMessage(
            correlation_id=self.correlation_id,
            raw=struct.pack(">i", len(payload)) + payload,
        )


@dataclass
class ResponseMessage:
    correlation_id: int
    raw: bytes

    @staticmethod
    def parse_correlation_id(frame: bytes) -> int:
        """Peek the correlation ID of a response frame."""
        if len(frame) < 8:
            raise KafkaParseError("response frame too short")
        return struct.unpack_from(">i", frame, 4)[0]


def _parse_topics(r: _Reader, api_key: int, api_version: int) -> list[str]:
    """Extract topic names for the six inspected request types."""
    topics: list[str] = []

    if api_key == PRODUCE_KEY:
        if api_version >= 3:
            r.string()  # transactional_id
        r.int16()  # acks
        r.int32()  # timeout
        n = r.int32()
        for _ in range(max(n, 0)):
            topics.append(r.string() or "")
            # partitions array: [partition(int32) record_set(bytes)]
            pn = r.int32()
            for _ in range(max(pn, 0)):
                r.int32()
                rec = r.bytes_()
    elif api_key == FETCH_KEY:
        r.int32()  # replica_id
        r.int32()  # max_wait
        r.int32()  # min_bytes
        if api_version >= 3:
            r.int32()  # max_bytes
        if api_version >= 4:
            r.int8()  # isolation_level
        n = r.int32()
        for _ in range(max(n, 0)):
            topics.append(r.string() or "")
            pn = r.int32()
            for _ in range(max(pn, 0)):
                r.int32()  # partition
                r.int64()  # fetch_offset
                if api_version >= 5:
                    r.int64()  # log_start_offset
                r.int32()  # max_bytes
    elif api_key == OFFSETS_KEY:
        r.int32()  # replica_id
        if api_version >= 2:
            r.int8()  # isolation_level
        n = r.int32()
        for _ in range(max(n, 0)):
            topics.append(r.string() or "")
            pn = r.int32()
            for _ in range(max(pn, 0)):
                r.int32()  # partition
                r.int64()  # timestamp
                if api_version == 0:
                    r.int32()  # max_num_offsets
    elif api_key == METADATA_KEY:
        n = r.int32()
        for _ in range(max(n, 0)):  # -1 = all topics
            topics.append(r.string() or "")
    elif api_key == OFFSET_COMMIT_KEY:
        r.string()  # group_id
        if api_version >= 1:
            r.int32()  # generation_id
            r.string()  # member_id
        if api_version >= 2:
            r.int64()  # retention_time
        n = r.int32()
        for _ in range(max(n, 0)):
            topics.append(r.string() or "")
            pn = r.int32()
            for _ in range(max(pn, 0)):
                r.int32()  # partition
                r.int64()  # offset
                if api_version == 1:
                    r.int64()  # timestamp
                r.string()  # metadata
    elif api_key == OFFSET_FETCH_KEY:
        r.string()  # group_id
        n = r.int32()
        for _ in range(max(n, 0)):
            topics.append(r.string() or "")
            pn = r.int32()
            for _ in range(max(pn, 0)):
                r.int32()  # partition
    return topics


def parse_request(frame: bytes) -> RequestMessage:
    """Parse one length-prefixed request frame
    (reference: request.go:186 ReadRequest)."""
    if len(frame) < 4:
        raise KafkaParseError("frame shorter than length prefix")
    (length,) = struct.unpack_from(">i", frame, 0)
    if length < 8 or 4 + length > len(frame):
        raise KafkaParseError(f"bad frame length {length}")
    r = _Reader(frame[4:4 + length])
    api_key = r.int16()
    api_version = r.int16()
    correlation_id = r.int32()
    client_id = r.string() or ""
    msg = RequestMessage(
        api_key=api_key,
        api_version=api_version,
        correlation_id=correlation_id,
        client_id=client_id,
        raw=frame[:4 + length],
    )
    if api_key in PARSED_TOPIC_KEYS:
        try:
            msg.topics = _parse_topics(r, api_key, api_version)
            msg.parsed = True
        except KafkaParseError:
            # Header-only fallback, like the reference when the library
            # can't parse the body (policy.go matchNonTopicRequests).
            msg.topics = []
            msg.parsed = False
    return msg


def frame_length(buf: bytes) -> Optional[int]:
    """Total frame size (prefix included) if the length field is complete."""
    if len(buf) < 4:
        return None
    (length,) = struct.unpack_from(">i", buf, 0)
    if length < 0:
        raise KafkaParseError(f"negative frame length {length}")
    return 4 + length


def _error_response_body(req: RequestMessage, error_code: int) -> bytes:
    """Version-aware error response per API key (reference:
    request.go:158 CreateResponse family): every inspected topic gets the
    error code in a body shaped for the request's api_version, so clients
    receive a clean TOPIC_AUTHORIZATION_FAILED instead of a parse error."""
    w = bytearray()
    v = req.api_version

    def put16(x):
        w.extend(struct.pack(">h", x))

    def put32(x):
        w.extend(struct.pack(">i", x))

    def put64(x):
        w.extend(struct.pack(">q", x))

    def put_str(s):
        b = s.encode()
        put16(len(b))
        w.extend(b)

    if req.api_key == PRODUCE_KEY:
        put32(len(req.topics))
        for t in req.topics:
            put_str(t)
            put32(1)  # one partition entry
            put32(0)  # partition
            put16(error_code)
            put64(-1)  # base_offset
            if v >= 2:
                put64(-1)  # log_append_time
        if v >= 1:
            put32(0)  # throttle_time_ms (trailing for produce)
    elif req.api_key == FETCH_KEY:
        if v >= 1:
            put32(0)  # throttle_time_ms (leading for fetch)
        put32(len(req.topics))
        for t in req.topics:
            put_str(t)
            put32(1)
            put32(0)  # partition
            put16(error_code)
            put64(-1)  # high_watermark
            if v >= 4:
                put64(-1)  # last_stable_offset
                if v >= 5:
                    put64(-1)  # log_start_offset
                put32(0)  # aborted_transactions count
            put32(0)  # record set size
    elif req.api_key == OFFSETS_KEY:
        if v >= 2:
            put32(0)  # throttle_time_ms
        put32(len(req.topics))
        for t in req.topics:
            put_str(t)
            put32(1)
            put32(0)  # partition
            put16(error_code)
            if v == 0:
                put32(0)  # offsets array (empty)
            else:
                put64(-1)  # timestamp
                put64(-1)  # offset
    elif req.api_key == METADATA_KEY:
        if v >= 3:
            put32(0)  # throttle_time_ms
        put32(0)  # brokers
        if v >= 2:
            put_str("")  # cluster_id
        if v >= 1:
            put32(-1)  # controller_id
        put32(len(req.topics))
        for t in req.topics:
            put16(error_code)
            put_str(t)
            if v >= 1:
                w.extend(b"\x00")  # is_internal
            put32(0)  # partitions
    elif req.api_key == OFFSET_COMMIT_KEY:
        if v >= 3:
            put32(0)  # throttle_time_ms
        put32(len(req.topics))
        for t in req.topics:
            put_str(t)
            put32(1)
            put32(0)  # partition
            put16(error_code)
    elif req.api_key == OFFSET_FETCH_KEY:
        if v >= 3:
            put32(0)  # throttle_time_ms
        put32(len(req.topics))
        for t in req.topics:
            put_str(t)
            put32(1)
            put32(0)  # partition
            put64(-1)  # offset
            put_str("")  # metadata
            put16(error_code)
        if v >= 2:
            put16(error_code)  # top-level error
    else:
        # Uninspected request types get an empty body; clients treat the
        # missing payload as a broker error.
        pass
    return bytes(w)

"""Cassandra CQL native-protocol (v3/v4) parser and L7 rules.

A copy of ``cilium_tpu/proxylib/parsers/cassandra.py``: the streaming
parser drives ``runtime/l7engine.CassandraBatchEngine``'s connections and
``CassandraRule`` is the host oracle of ``models/cassandra.py``.

Reference: proxylib/cassandra/cassandraparser.go.  Frames are
9-byte-header binary messages; requests with a query-like opcode
(query/prepare/batch/execute) are matched on ``query_action`` (exact)
and ``query_table`` (regex, search semantics) extracted from the CQL
text; other opcodes always pass the L7 rules.  Prepared statements are
tracked: PREPARE stashes the parsed path by stream-id, the server's
RESULT(prepared) reply binds it to the prepared-id, and EXECUTE/batch
entries look the path up by prepared-id — an unknown id injects an
``unprepared`` error so the client re-prepares
(reference: cassandraparser.go:586-601).

Deliberate divergences from the reference, after analysis:
- Batch frames: the reference reads the query count as a 16-bit int
  from a 1-byte slice and walks entries from offset 11
  (cassandraparser.go:519-522), which can never execute without a
  runtime panic; this parser follows the protocol spec — count is a
  big-endian u16 at bytes 10..12, entries start at offset 12.
- The per-frame inject of the unprepared error and its prepared-id
  trailer are emitted as one buffer write instead of two consecutive
  Inject calls (byte stream identical).

The ``query_table`` regex compiles through ``cilium_tpu_torch.regex`` —
the same automaton the device model evaluates — so the streaming oracle
and the device path share one compiled semantics.
"""

from __future__ import annotations

import struct

from ...regex import CompiledPattern, compile_pattern, py_search
from ...regex.parse import ParseError as RegexParseError
from ..accesslog import EntryType
from ..parser import parse_error, register_l7_rule_parser, register_parser_factory
from ..types import DROP, ERROR, MORE, PASS, OpError

CASS_HDR_LEN = 9
CASS_MAX_LEN = 268435456  # 256 MB, per spec

OPCODE_MAP = {
    0x00: "error",
    0x01: "startup",
    0x02: "ready",
    0x03: "authenticate",
    0x05: "options",
    0x06: "supported",
    0x07: "query",
    0x08: "result",
    0x09: "prepare",
    0x0A: "execute",
    0x0B: "register",
    0x0C: "event",
    0x0D: "batch",
    0x0E: "auth_challenge",
    0x0F: "auth_response",
    0x10: "auth_success",
}

# query_action validity (reference: cassandraparser.go:315-366)
INVALID_ACTION = 0
ACTION_WITH_TABLE = 1
ACTION_NO_TABLE = 2

QUERY_ACTION_MAP = {
    "select": ACTION_WITH_TABLE,
    "delete": ACTION_WITH_TABLE,
    "insert": ACTION_WITH_TABLE,
    "update": ACTION_WITH_TABLE,
    "create-table": ACTION_WITH_TABLE,
    "drop-table": ACTION_WITH_TABLE,
    "alter-table": ACTION_WITH_TABLE,
    "truncate-table": ACTION_WITH_TABLE,
    "use": ACTION_WITH_TABLE,
    "create-keyspace": ACTION_WITH_TABLE,
    "alter-keyspace": ACTION_WITH_TABLE,
    "drop-keyspace": ACTION_WITH_TABLE,
    "drop-index": ACTION_NO_TABLE,
    "create-index": ACTION_NO_TABLE,
    "create-materialized-view": ACTION_NO_TABLE,
    "drop-materialized-view": ACTION_NO_TABLE,
    "create-role": ACTION_NO_TABLE,
    "alter-role": ACTION_NO_TABLE,
    "drop-role": ACTION_NO_TABLE,
    "grant-role": ACTION_NO_TABLE,
    "revoke-role": ACTION_NO_TABLE,
    "list-roles": ACTION_NO_TABLE,
    "grant-permission": ACTION_NO_TABLE,
    "revoke-permission": ACTION_NO_TABLE,
    "list-permissions": ACTION_NO_TABLE,
    "create-user": ACTION_NO_TABLE,
    "alter-user": ACTION_NO_TABLE,
    "drop-user": ACTION_NO_TABLE,
    "list-users": ACTION_NO_TABLE,
    "create-function": ACTION_NO_TABLE,
    "drop-function": ACTION_NO_TABLE,
    "create-aggregate": ACTION_NO_TABLE,
    "drop-aggregate": ACTION_NO_TABLE,
    "create-type": ACTION_NO_TABLE,
    "alter-type": ACTION_NO_TABLE,
    "drop-type": ACTION_NO_TABLE,
    "create-trigger": ACTION_NO_TABLE,
    "drop-trigger": ACTION_NO_TABLE,
}

# Fixed "Request Unauthorized" error frame; version and stream-id are
# patched per request before injection (reference: cassandraparser.go:269).
UNAUTH_MSG_BASE = bytes(
    [
        0x0,  # version - patched
        0x0,  # flags
        0x0, 0x0,  # stream-id - patched
        0x0,  # opcode error
        0x0, 0x0, 0x0, 0x1A,  # body length
        0x0, 0x0, 0x21, 0x00,  # unauthorized error code 0x2100
        0x0, 0x14,  # error message length
    ]
) + b"Request Unauthorized"

# "Unprepared" error prefix; the prepared-id in [short bytes] form is
# appended per request (reference: cassandraparser.go:284).
UNPREPARED_MSG_BASE = bytes(
    [
        0x0,  # version - patched
        0x0,  # flags
        0x0, 0x0,  # stream-id - patched
        0x0,  # opcode error
        0x0, 0x0, 0x0, 0x1A,  # body length
        0x0, 0x0, 0x25, 0x00,  # unprepared error code 0x2500
    ]
)


class CassandraRule:
    """One allow-rule on (query_action, query_table)
    (reference: cassandraparser.go:50-95)."""

    def __init__(self, query_action_exact: str = "", table_regex: str = ""):
        self.query_action_exact = query_action_exact
        self.table_regex = table_regex
        self.table_compiled: CompiledPattern | None = (
            compile_pattern(table_regex) if table_regex else None
        )

    def matches(self, data) -> bool:
        if not isinstance(data, str):
            return False
        parts = data.split("/")
        if len(parts) <= 2:
            return True  # not a query-like request: allow
        if len(parts) < 4:
            return False  # malformed internal path
        if self.query_action_exact and self.query_action_exact != parts[2]:
            return False
        if (
            parts[3]
            and self.table_compiled is not None
            and not py_search(
                self.table_compiled,
                parts[3].encode("utf-8", "surrogateescape"),
            )
        ):
            return False
        return True


def cassandra_rule_parser(rule_config):
    """(reference: cassandraparser.go:99-134, incl. validation)."""
    rules = []
    for kv in rule_config.l7_rules or []:
        action, table = "", ""
        for k, v in kv.items():
            if k == "query_action":
                action = v
            elif k == "query_table":
                table = v
            else:
                parse_error(f"Unsupported key: {k}", rule_config)
        if action:
            res = QUERY_ACTION_MAP.get(action, INVALID_ACTION)
            if res == INVALID_ACTION:
                parse_error(
                    "Unable to parse L7 cassandra rule with invalid "
                    f"query_action: '{action}'",
                    rule_config,
                )
            elif res == ACTION_NO_TABLE and table:
                parse_error(
                    f"query_action '{action}' is not compatible with a "
                    "query_table match",
                    rule_config,
                )
        try:
            rules.append(CassandraRule(action, table))
        except RegexParseError as e:
            parse_error(f"invalid query_table regex: {e}", rule_config)
    return rules


def parse_query(parser: "CassandraParser", query: str) -> tuple[str, str]:
    """CQL text -> (action, table); ('', '') when unparseable
    (reference: cassandraparser.go:368-469)."""
    query = query.rstrip(";")
    fields = query.lower().split()

    # Comment tokens make the table extraction unsafe: fail parsing
    # (reference: cassandraparser.go:383-392).
    for f in fields:
        if len(f) >= 2 and (f[:2] == "--" or f[:2] == "/*" or f[:2] == "//"):
            return "", ""
    if len(fields) < 2:
        return "", ""

    action = fields[0]
    table = ""
    if action in ("select", "delete"):
        for i in range(1, len(fields)):
            if fields[i] == "from" and i + 1 < len(fields):
                table = fields[i + 1].lower()
        if not table:
            return "", ""
    elif action == "insert":
        if len(fields) < 3:
            return "", ""
        table = fields[2].lower()
    elif action == "update":
        table = fields[1].lower()
    elif action == "use":
        parser.keyspace = fields[1].strip("\"\\'")
        table = parser.keyspace
    elif action in ("alter", "create", "drop", "truncate", "list"):
        action = f"{action}-{fields[1]}"
        if fields[1] in ("table", "keyspace"):
            if len(fields) < 3:
                return "", ""
            table = fields[2]
            if table == "if":
                if action == "create-table":
                    if len(fields) < 6:
                        return "", ""
                    table = fields[5]  # skip "IF NOT EXISTS"
                elif action in ("drop-table", "drop-keyspace"):
                    if len(fields) < 5:
                        return "", ""
                    table = fields[4]  # skip "IF EXISTS"
        # NOTE: bare "TRUNCATE <t>" yields action "truncate-<t>" with no
        # table — the reference's special case for it is unreachable
        # (action already rewritten; cassandraparser.go:424,447-450) and
        # that behavior is preserved here.
        if fields[1] == "materialized":
            action += "-view"
        elif fields[1] == "custom":
            action = "create-index"
    else:
        return "", ""

    if table and "." not in table and action != "use":
        table = f"{parser.keyspace}.{table}"
    return action, table


class CassandraParser:
    """(reference: cassandraparser.go:146-262)."""

    def __init__(self, connection):
        self.connection = connection
        self.keyspace = ""
        # PREPARE path stashed by stream-id until the server's
        # RESULT(prepared) reply binds it to the prepared-id.
        self.prepared_path_by_stream_id: dict[int, str] = {}
        self.prepared_path_by_prepared_id: dict[bytes, str] = {}

    def on_data(self, reply, end_stream, data):
        joined = b"".join(data)
        if len(joined) < CASS_HDR_LEN:
            return MORE, CASS_HDR_LEN - len(joined)
        request_len = struct.unpack_from(">I", joined, 5)[0]
        if request_len > CASS_MAX_LEN:
            return ERROR, int(OpError.ERROR_INVALID_FRAME_LENGTH)
        missing = CASS_HDR_LEN + request_len - len(joined)
        if missing > 0:
            return MORE, missing
        frame = joined[: CASS_HDR_LEN + request_len]

        if reply:
            self._parse_reply(frame)
            return PASS, len(frame)

        err, paths = self._parse_request(frame)
        if err:
            return ERROR, int(err)

        matches = True
        entry_type = EntryType.Request
        for path in paths:
            if not self.connection.matches(path):
                matches = False
                entry_type = EntryType.Denied

        for path in paths:
            parts = path.split("/")
            if len(parts) == 4:
                self.connection.log(
                    entry_type,
                    proto="cassandra",
                    fields={
                        "query_action": parts[2],
                        "query_table": parts[3],
                    },
                )

        if not matches:
            unauth = bytearray(UNAUTH_MSG_BASE)
            unauth[0] = 0x80 | (frame[0] & 0x07)
            unauth[2] = frame[2]
            unauth[3] = frame[3]
            self.connection.inject(True, bytes(unauth))
            return DROP, len(frame)
        return PASS, len(frame)

    # -- request/reply body parsing --------------------------------------

    def _send_unprepared(self, version: int, stream_id: bytes,
                         prepared_id_short_bytes: bytes) -> None:
        msg = bytearray(UNPREPARED_MSG_BASE)
        msg[0] = 0x80 | (version & 0x07)
        msg[2] = stream_id[0]
        msg[3] = stream_id[1]
        # Divergence: the reference leaves the body-length field at the
        # hardcoded 0x1A regardless of the appended prepared-id length
        # (cassandraparser.go:284-292), producing a malformed frame for
        # any id length other than 20; patch the real length.
        body_len = 4 + len(prepared_id_short_bytes)  # error code + id
        struct.pack_into(">I", msg, 5, body_len)
        self.connection.inject(True, bytes(msg) + prepared_id_short_bytes)

    def _parse_request(self, data: bytes):
        """Returns (OpError | 0, [path...]) (reference:
        cassandraparser.go:471-581)."""
        if data[0] & 0x80:
            return OpError.ERROR_INVALID_FRAME_TYPE, None
        if data[1] & 0x01:
            return OpError.ERROR_INVALID_FRAME_TYPE, None  # compressed

        opcode = data[4]
        path = OPCODE_MAP.get(opcode, "")
        if opcode in (0x07, 0x09):  # query | prepare
            (query_len,) = struct.unpack_from(">I", data, 9)
            query = data[13 : 13 + query_len].decode("utf-8", "surrogateescape")
            action, table = parse_query(self, query)
            if not action:
                return OpError.ERROR_INVALID_FRAME_TYPE, None
            path = f"/{path}/{action}/{table}"
            if opcode == 0x09:
                (stream_id,) = struct.unpack_from(">H", data, 2)
                self.prepared_path_by_stream_id[stream_id] = path.replace(
                    "prepare", "execute", 1
                )
            return 0, [path]
        if opcode == 0x0D:  # batch (spec-correct framing, see module doc)
            (num_queries,) = struct.unpack_from(">H", data, 10)
            paths = []
            offset = 12
            for _ in range(num_queries):
                kind = data[offset]
                if kind == 0:  # inline query string
                    (query_len,) = struct.unpack_from(">I", data, offset + 1)
                    query = data[offset + 5 : offset + 5 + query_len].decode(
                        "utf-8", "surrogateescape"
                    )
                    action, table = parse_query(self, query)
                    if not action:
                        return OpError.ERROR_INVALID_FRAME_TYPE, None
                    paths.append(f"/batch/{action}/{table}")
                    offset += 5 + query_len
                elif kind == 1:  # prepared query id
                    (id_len,) = struct.unpack_from(">H", data, offset + 1)
                    prepared_id = data[offset + 3 : offset + 3 + id_len]
                    cached = self.prepared_path_by_prepared_id.get(prepared_id)
                    if not cached:
                        self._send_unprepared(
                            data[0], data[2:4],
                            data[offset + 1 : offset + 3 + id_len],
                        )
                        return OpError.ERROR_INVALID_FRAME_TYPE, None
                    paths.append(cached)
                    offset += 3 + id_len
                else:
                    return OpError.ERROR_INVALID_FRAME_TYPE, None
            return 0, paths
        if opcode == 0x0A:  # execute
            (id_len,) = struct.unpack_from(">H", data, 9)
            prepared_id = data[11 : 11 + id_len]
            cached = self.prepared_path_by_prepared_id.get(prepared_id)
            if not cached:
                self._send_unprepared(data[0], data[2:4], data[9 : 11 + id_len])
                return OpError.ERROR_INVALID_FRAME_TYPE, None
            return 0, [cached]
        return 0, [f"/{path}"]

    def _parse_reply(self, data: bytes) -> None:
        """Associates RESULT(prepared) ids with stashed PREPARE paths
        (reference: cassandraparser.go:605-642)."""
        if not data[0] & 0x80:
            return
        if data[1] & 0x01:
            return  # compressed
        (stream_id,) = struct.unpack_from(">H", data, 2)
        if data[4] == 0x08:  # RESULT
            (result_kind,) = struct.unpack_from(">I", data, 9)
            if result_kind == 0x0004:  # prepared
                (id_len,) = struct.unpack_from(">H", data, 13)
                prepared_id = data[15 : 15 + id_len]
                path = self.prepared_path_by_stream_id.get(stream_id)
                if path:
                    self.prepared_path_by_prepared_id[prepared_id] = path


class CassandraParserFactory:
    def create(self, connection):
        return CassandraParser(connection)


register_parser_factory("cassandra", CassandraParserFactory())
register_l7_rule_parser("cassandra", cassandra_rule_parser)

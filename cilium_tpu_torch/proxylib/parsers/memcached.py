"""Memcached parser (text + binary wire protocols) and L7 rules.

A copy of ``cilium_tpu/proxylib/parsers/memcached.py``: the streaming
parsers drive ``runtime/l7engine.MemcacheBatchEngine``'s connections and
``MemcacheRule`` is the host oracle of ``models/memcached.py``.

Reference: proxylib/memcached/{parser.go,binary/parser.go,text/parser.go,
meta/meta.go}.  The unified parser sniffs the first byte of the first
request (>= 0x80 means binary) and delegates to the protocol parser for
the rest of the connection.  Rules allow a ``command`` (a name or group
from MEMCACHE_OPCODE_MAP expanding to text commands + binary opcodes)
and optionally constrain keys with exactly one of ``keyExact`` /
``keyPrefix`` / ``keyRegex``; denials inject protocol-appropriate
"access denied" replies, kept in request order with a reply-intent
queue.

Deliberate divergence: the reference's binary parser enqueues a denial
into its inject queue even when it was already injected inline
(binary/parser.go:129-135 appends twice), permanently wedging the queue
head so later queued denials never inject; here a denial is either
injected immediately or queued, exactly once.

``keyRegex`` compiles through ``cilium_tpu_torch.regex`` — the same
automaton the device model evaluates.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

from ...regex import CompiledPattern, compile_pattern, py_search
from ...regex.parse import ParseError as RegexParseError
from ..accesslog import EntryType
from ..parser import parse_error, register_l7_rule_parser, register_parser_factory
from ..types import DROP, ERROR, INJECT, MORE, NOP, PASS, OpError


@dataclass
class MemcacheMeta:
    """Frame metadata handed to rule matching (reference: meta/meta.go)."""

    command: str = ""  # text protocol
    opcode: int = -1  # binary protocol
    keys: list[bytes] = field(default_factory=list)

    def is_binary(self) -> bool:
        return not self.command


# command name / group -> (text command set, binary opcode set)
# (reference: parser.go:214-474 MemcacheOpCodeMap)
_STORAGE_TEXT = {"add", "set", "replace", "append", "prepend", "cas", "incr", "decr"}
_STORAGE_BIN = {1, 2, 3, 5, 6, 17, 18, 19, 21, 22, 25, 26}

MEMCACHE_OPCODE_MAP: dict[str, tuple[frozenset, frozenset]] = {
    "add": (frozenset({"add"}), frozenset({2, 18})),
    "set": (frozenset({"set"}), frozenset({1, 17})),
    "replace": (frozenset({"replace"}), frozenset({3, 19})),
    "append": (frozenset({"append"}), frozenset({14, 25})),
    "prepend": (frozenset({"prepend"}), frozenset({15, 26})),
    "cas": (frozenset({"cas"}), frozenset()),
    "incr": (frozenset({"incr"}), frozenset({5, 21})),
    "decr": (frozenset({"decr"}), frozenset({6, 22})),
    "storage": (frozenset(_STORAGE_TEXT), frozenset(_STORAGE_BIN)),
    "get": (frozenset({"get", "gets"}), frozenset({0, 9, 12, 13})),
    "delete": (frozenset({"delete"}), frozenset({4, 20})),
    "touch": (frozenset({"touch"}), frozenset({28})),
    "gat": (frozenset({"gat", "gats"}), frozenset({29, 30})),
    "writeGroup": (
        frozenset(_STORAGE_TEXT | {"delete", "touch"}),
        frozenset(_STORAGE_BIN | {4, 20, 28}),
    ),
    "slabs": (frozenset({"slabs"}), frozenset()),
    "lru": (frozenset({"lru"}), frozenset()),
    "lru_crawler": (frozenset({"lru_crawler"}), frozenset()),
    "watch": (frozenset({"watch"}), frozenset()),
    "stats": (frozenset({"stats"}), frozenset({16})),
    "flush_all": (frozenset({"flush_all"}), frozenset({8, 24})),
    "cache_memlimit": (frozenset({"cache_memlimit"}), frozenset()),
    "version": (frozenset({"version"}), frozenset({11})),
    "misbehave": (frozenset({"misbehave"}), frozenset()),
    "quit": (frozenset({"quit"}), frozenset({7, 23})),
    "noop": (frozenset(), frozenset({10})),
    "verbosity": (frozenset(), frozenset({27})),
    "sasl-list-mechs": (frozenset(), frozenset({32})),
    "sasl-auth": (frozenset(), frozenset({33})),
    "sasl-step": (frozenset(), frozenset({34})),
    "rget": (frozenset(), frozenset({48})),
    "rset": (frozenset(), frozenset({49})),
    "rsetq": (frozenset(), frozenset({50})),
    "rappend": (frozenset(), frozenset({51})),
    "rappendq": (frozenset(), frozenset({52})),
    "rprepend": (frozenset(), frozenset({53})),
    "rprependq": (frozenset(), frozenset({54})),
    "rdelete": (frozenset(), frozenset({55})),
    "rdeleteq": (frozenset(), frozenset({56})),
    "rincr": (frozenset(), frozenset({57})),
    "rincrq": (frozenset(), frozenset({58})),
    "rdecr": (frozenset(), frozenset({59})),
    "rdecrq": (frozenset(), frozenset({60})),
    "set-vbucket": (frozenset(), frozenset({61})),
    "get-vbucket": (frozenset(), frozenset({62})),
    "del-vbucket": (frozenset(), frozenset({63})),
    "tap-connect": (frozenset(), frozenset({64})),
    "tap-mutation": (frozenset(), frozenset({65})),
    "tap-delete": (frozenset(), frozenset({66})),
    "tap-flush": (frozenset(), frozenset({67})),
    "tap-opaque": (frozenset(), frozenset({68})),
    "tap-vbucket-set": (frozenset(), frozenset({69})),
    "tap-checkpoint-start": (frozenset(), frozenset({70})),
    "tap-checkpoint-end": (frozenset(), frozenset({71})),
}


class MemcacheRule:
    """One allow-rule on (command set, key constraint)
    (reference: parser.go:35-100)."""

    def __init__(self, text_cmds=frozenset(), bin_opcodes=frozenset(),
                 key_exact: bytes = b"", key_prefix: bytes = b"",
                 key_regex: str = "", empty: bool = False):
        self.text_cmds = text_cmds
        self.bin_opcodes = bin_opcodes
        self.key_exact = key_exact
        self.key_prefix = key_prefix
        self.key_regex = key_regex
        self.key_compiled: CompiledPattern | None = (
            compile_pattern(key_regex) if key_regex else None
        )
        self.empty = empty

    def matches(self, data) -> bool:
        if not isinstance(data, MemcacheMeta):
            return False
        if self.empty:
            return True
        if data.is_binary():
            if data.opcode not in self.bin_opcodes:
                return False
        else:
            if data.command not in self.text_cmds:
                return False
        if self.key_exact:
            return all(k == self.key_exact for k in data.keys)
        if self.key_prefix:
            return all(k.startswith(self.key_prefix) for k in data.keys)
        if self.key_compiled is not None:
            return all(py_search(self.key_compiled, k) for k in data.keys)
        return True


def memcache_rule_parser(rule_config):
    """(reference: parser.go:114-148)."""
    rules = []
    for kv in rule_config.l7_rules or []:
        text_cmds, bin_ops = frozenset(), frozenset()
        key_exact, key_prefix, key_regex = b"", b"", ""
        command_found = False
        for k, v in kv.items():
            if k == "command":
                sets = MEMCACHE_OPCODE_MAP.get(v)
                if sets is None:
                    # Divergence: the reference leaves an unknown command
                    # name as a not-found lookup, which (without a key
                    # constraint) silently builds an allow-everything
                    # rule (parser.go:126,137-142) — a typo fails open.
                    # Reject it instead.
                    parse_error(f"Unknown command: {v}", rule_config)
                text_cmds, bin_ops = sets
                command_found = True
            elif k == "keyExact":
                key_exact = v.encode("utf-8", "surrogateescape")
            elif k == "keyPrefix":
                key_prefix = v.encode("utf-8", "surrogateescape")
            elif k == "keyRegex":
                key_regex = v
            else:
                parse_error(f"Unsupported key: {k}", rule_config)
        empty = False
        if not command_found:
            if key_exact or key_prefix or key_regex:
                parse_error(
                    "command not specified but key was provided", rule_config
                )
            else:
                empty = True
        try:
            rules.append(
                MemcacheRule(
                    text_cmds, bin_ops, key_exact, key_prefix, key_regex, empty
                )
            )
        except RegexParseError as e:
            parse_error(f"invalid keyRegex: {e}", rule_config)
    return rules


# --- binary protocol -----------------------------------------------------

BINARY_HEADER_SIZE = 24
REQUEST_MAGIC = 0x80
RESPONSE_MAGIC = 0x81

# Fixed "access denied" binary error reply (status 0x000d = busy-ish per
# reference; magic patched per request; reference: binary/parser.go:194).
BINARY_DENIED_MSG = bytes(
    [
        0x81, 0, 0, 0,
        0, 0, 0, 8,
        0, 0, 0, 0x0D,
        0, 0, 0, 0,
        0, 0, 0, 0,
        0, 0, 0, 0,
    ]
) + b"access denied"


class BinaryMemcacheParser:
    """(reference: binary/parser.go:44-191)."""

    def __init__(self, connection):
        self.connection = connection
        self.request_count = 0
        self.reply_count = 0
        # (magic, request_id) denials waiting for their in-order slot.
        self.inject_queue: list[tuple[int, int]] = []

    def _inject_denied(self, magic: int) -> None:
        msg = bytearray(BINARY_DENIED_MSG)
        msg[0] = magic
        self.connection.inject(True, bytes(msg))
        self.reply_count += 1

    def _inject_from_queue(self) -> bool:
        if self.inject_queue and self.inject_queue[0][1] == self.reply_count + 1:
            magic, _ = self.inject_queue.pop(0)
            self._inject_denied(magic)
            return True
        return False

    def on_data(self, reply, end_stream, data):
        if reply:
            if self._inject_from_queue():
                return INJECT, len(BINARY_DENIED_MSG)
            if not data:  # list emptiness, matching the reference
                return NOP, 0
        joined = b"".join(data)
        if len(joined) < BINARY_HEADER_SIZE:
            return MORE, BINARY_HEADER_SIZE - len(joined)

        (body_len,) = struct.unpack_from(">I", joined, 8)
        (key_len,) = struct.unpack_from(">H", joined, 2)
        extras_len = joined[4]
        if key_len > 0:
            needed = BINARY_HEADER_SIZE + key_len + extras_len
            if needed > len(joined):
                return MORE, needed - len(joined)

        opcode = joined[1]
        key = (
            joined[
                BINARY_HEADER_SIZE + extras_len :
                BINARY_HEADER_SIZE + extras_len + key_len
            ]
            if key_len
            else b""
        )
        fields = {"opcode": str(opcode), "key": key.decode("utf-8", "surrogateescape")}
        frame_len = BINARY_HEADER_SIZE + body_len

        # The 0x80 magic bit must be present in BOTH directions: the
        # reference validates it in getOpcodeAndKey (binary/parser.go)
        # before ever branching on reply, so a malformed reply frame is
        # an invalid-frame error, not a PASS.
        if not joined[0] & REQUEST_MAGIC:
            return ERROR, int(OpError.ERROR_INVALID_FRAME_TYPE)

        if reply:
            self.connection.log(
                EntryType.Response, proto="binarymemcached", fields=fields
            )
            self.reply_count += 1
            return PASS, frame_len

        self.request_count += 1
        meta = MemcacheMeta(opcode=opcode, keys=[key])
        if self.connection.matches(meta):
            self.connection.log(
                EntryType.Request, proto="binarymemcached", fields=fields
            )
            return PASS, frame_len

        magic = RESPONSE_MAGIC | joined[0]
        # In-order denial replies: inject now only if every earlier
        # request has been answered, else queue (exactly once — see the
        # divergence note in the module docstring).
        if self.request_count == self.reply_count + 1:
            self._inject_denied(magic)
        else:
            self.inject_queue.append((magic, self.request_count))
        self.connection.log(
            EntryType.Denied, proto="binarymemcached", fields=fields
        )
        return DROP, frame_len


# --- text protocol -------------------------------------------------------

TEXT_DENIED_MSG = b"CLIENT_ERROR access denied\r\n"
_PAYLOAD_END = b"\r\nEND\r\n"

# token counts that indicate a trailing "noreply" (reference:
# text/parser.go:63-69)
_CAS_NOREPLY = 7
_STORAGE_NOREPLY = 6
_DELETE_NOREPLY = 3
_INCR_NOREPLY = 4
_TOUCH_NOREPLY = 4

_FLAT_COMMANDS = (
    b"slabs", b"lru", b"lru_crawler", b"stats", b"version", b"misbehave",
)


def _is_retrieval(cmd: bytes) -> bool:
    return cmd.startswith(b"get") or cmd.startswith(b"gat")


def _is_storage(cmd: bytes) -> bool:
    return cmd in (b"set", b"add", b"replace", b"append", b"prepend", b"cas")


def _is_incr_decr(cmd: bytes) -> bool:
    return cmd in (b"incr", b"decr")


def _is_error_reply(tok: bytes) -> bool:
    return tok in (b"ERROR", b"CLIENT_ERROR", b"SERVER_ERROR")


class TextMemcacheParser:
    """(reference: text/parser.go:45-302)."""

    def __init__(self, connection):
        self.connection = connection
        # (command, denied) intents, one per reply expected in order.
        self.reply_queue: list[tuple[bytes, bool]] = []
        self.watching = False

    def _inject_from_queue(self) -> int:
        injected = 0
        for cmd, denied in self.reply_queue:
            if denied:
                injected += 1
                self.connection.inject(True, TEXT_DENIED_MSG)
            else:
                break
        if injected:
            del self.reply_queue[:injected]
        return injected * len(TEXT_DENIED_MSG)

    def on_data(self, reply, end_stream, data):
        if reply:
            injected = self._inject_from_queue()
            if injected > 0:
                return INJECT, injected
            if not data:  # list emptiness, matching the reference
                return NOP, 0
        joined = b"".join(data)
        linefeed = joined.find(b"\r\n")
        if linefeed < 0:
            if joined and joined[-1:] == b"\r":
                return MORE, 1
            return MORE, 2
        tokens = joined[:linefeed].split()

        if not reply:
            return self._on_request(joined, linefeed, tokens)
        return self._on_reply(joined, linefeed, tokens)

    def _on_request(self, joined, linefeed, tokens):
        if not tokens:
            return ERROR, 0
        command = tokens[0]
        meta = MemcacheMeta(command=command.decode("ascii", "replace"))
        frame_len = linefeed + 2
        has_noreply = False

        if _is_retrieval(command):
            if command.startswith(b"get"):
                meta.keys = tokens[1:]
            else:
                meta.keys = tokens[2:]
        elif _is_storage(command):
            meta.keys = tokens[1:2]
            try:
                n_bytes = int(tokens[4])
            except (IndexError, ValueError):
                return ERROR, 0
            frame_len += n_bytes + 2  # data block + terminating CRLF
            if command[:1] == b"c":  # cas
                has_noreply = len(tokens) == _CAS_NOREPLY
            else:
                has_noreply = len(tokens) == _STORAGE_NOREPLY
        elif command == b"delete":
            meta.keys = tokens[1:2]
            has_noreply = len(tokens) == _DELETE_NOREPLY
        elif _is_incr_decr(command):
            meta.keys = tokens[1:2]
            has_noreply = len(tokens) == _INCR_NOREPLY
        elif command == b"touch":
            meta.keys = tokens[1:2]
            has_noreply = len(tokens) == _TOUCH_NOREPLY
        elif command in _FLAT_COMMANDS:
            meta.keys = []
        elif command in (b"flush_all", b"cache_memlimit"):
            meta.keys = []
            has_noreply = tokens[-1] == b"noreply"
        elif command == b"quit":
            meta.keys = []
            has_noreply = True
        elif command == b"watch":
            meta.keys = []
            self.watching = True
        else:
            return ERROR, 0

        fields = {
            "command": meta.command,
            "keys": b", ".join(meta.keys).decode("utf-8", "surrogateescape"),
        }
        if self.connection.matches(meta):
            if not has_noreply:
                self.reply_queue.append((command, False))
            self.connection.log(
                EntryType.Request, proto="textmemcached", fields=fields
            )
            return PASS, frame_len

        if not has_noreply:
            if not self.reply_queue:
                self.connection.inject(True, TEXT_DENIED_MSG)
            else:
                self.reply_queue.append((command, True))
        self.connection.log(
            EntryType.Denied, proto="textmemcached", fields=fields
        )
        return DROP, frame_len

    def _on_reply(self, joined, linefeed, tokens):
        if not self.reply_queue:
            # Unsolicited reply line (or reply to a noreply command):
            # nothing to correlate — protocol error (the reference
            # panics here and recovers to PARSER_ERROR).
            return ERROR, 0
        command, _denied = self.reply_queue[0]
        fields = {"command": command.decode("utf-8", "surrogateescape")}

        if self.watching:
            return PASS, linefeed + 2  # watch mode: pass every line

        if (
            (tokens and _is_error_reply(tokens[0]))
            or _is_storage(command)
            or command == b"delete"
            or _is_incr_decr(command)
            or command
            in (
                b"touch", b"slabs", b"lru", b"flush_all",
                b"cache_memlimit", b"version", b"misbehave",
            )
        ):
            self.connection.log(
                EntryType.Response, proto="textmemcached", fields=fields
            )
            self.reply_queue.pop(0)
            return PASS, linefeed + 2
        if _is_retrieval(command) or command == b"stats":
            op, n = self._until_end(joined)
            if op == PASS:
                self.connection.log(
                    EntryType.Response, proto="textmemcached", fields=fields
                )
                self.reply_queue.pop(0)
            return op, n
        if command == b"lru_crawler":
            if tokens and tokens[0] in (b"OK", b"BUSY", b"BADCLASS"):
                self.connection.log(
                    EntryType.Response, proto="textmemcached", fields=fields
                )
                self.reply_queue.pop(0)
                return PASS, linefeed + 2
            op, n = self._until_end(joined)
            if op == PASS:
                self.connection.log(
                    EntryType.Response, proto="textmemcached", fields=fields
                )
                self.reply_queue.pop(0)
            return op, n
        return ERROR, 0

    @staticmethod
    def _until_end(data: bytes):
        # A miss reply is the bare terminator line "END\r\n" — the
        # reference only searches for "\r\nEND\r\n" (text/parser.go:
        # 264-273) and would buffer a miss reply forever; divergence:
        # accept the terminator at offset 0.
        if data.startswith(_PAYLOAD_END[2:]):
            return PASS, len(_PAYLOAD_END) - 2
        end = data.find(_PAYLOAD_END)
        if end > 0:
            return PASS, end + len(_PAYLOAD_END)
        return MORE, 1


# --- unified sniffing parser (reference: parser.go:176-202) --------------

class MemcacheParser:
    def __init__(self, connection):
        self.connection = connection
        self.parser = None

    def on_data(self, reply, end_stream, data):
        if self.parser is None:
            first = b""
            for chunk in data:
                if chunk:
                    first = chunk[:1]
                    break
            if not first:
                return NOP, 0
            if first[0] >= 128:
                self.parser = BinaryMemcacheParser(self.connection)
            else:
                self.parser = TextMemcacheParser(self.connection)
        return self.parser.on_data(reply, end_stream, data)


class MemcacheParserFactory:
    def create(self, connection):
        return MemcacheParser(connection)


register_parser_factory("memcache", MemcacheParserFactory())
register_l7_rule_parser("memcache", memcache_rule_parser)

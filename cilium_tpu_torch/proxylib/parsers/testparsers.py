"""Test parsers: passer, line, block, header.

Byte-exact reimplementations of the reference's test parsers
(reference: proxylib/testparsers/{passer,lineparser,blockparser,
headerparser}.go) — they anchor the OnData op-sequence oracle tests.
"""

from __future__ import annotations

from ..accesslog import EntryType
from ..parser import parse_error, register_l7_rule_parser, register_parser_factory
from ..types import DROP, ERROR, INJECT, MORE, NOP, PASS, OpError


class PasserParser:
    """Passes everything (reference: testparsers/passer.go)."""

    def on_data(self, reply, end_stream, data):
        n = sum(len(s) for s in data)
        if n == 0:
            return NOP, 0
        return PASS, n


class PasserParserFactory:
    def create(self, connection):
        if connection.policy_name == "invalid-policy":
            return None  # reject based on connection metadata
        return PasserParser()


def get_line(data: list[bytes]) -> tuple[bytes, bool]:
    """First '\\n'-terminated line across chunks
    (reference: testparsers/lineparser.go getLine)."""
    line = bytearray()
    for s in data:
        idx = s.find(b"\n")
        if idx < 0:
            line += s
        else:
            line += s[: idx + 1]
            return bytes(line), True
    return bytes(line), False


class LineParser:
    """PASS/DROP/INJECT/INSERT line protocol
    (reference: testparsers/lineparser.go)."""

    def __init__(self, connection):
        self.connection = connection
        self.inserted = False

    def on_data(self, reply, end_stream, data):
        line, ok = get_line(data)
        line_len = len(line)
        if self.inserted:
            self.inserted = False
            return DROP, line_len
        if not ok:
            if line_len > 0:
                return MORE, 1
            return NOP, 0
        if line.startswith(b"PASS"):
            return PASS, line_len
        if line.startswith(b"DROP"):
            return DROP, line_len
        if line.startswith(b"INJECT"):
            self.connection.inject(not reply, line)
            return DROP, line_len
        if line.startswith(b"INSERT"):
            self.connection.inject(reply, line)
            self.inserted = True
            return INJECT, line_len
        return ERROR, int(OpError.ERROR_INVALID_FRAME_TYPE)


class LineParserFactory:
    def create(self, connection):
        return LineParser(connection)


def get_block(data: list[bytes]) -> tuple[bytes, int, int]:
    """Length-prefixed 'N:...' frame reassembly
    (reference: testparsers/blockparser.go getBlock).
    Returns (block, block_len, missing); raises ValueError on bad length."""
    block = bytearray()
    offset = 0
    block_len = 0
    have_length = False
    missing = 0
    for s in data:
        if not have_length:
            idx = s[offset:].find(b":")
            if idx < 0:
                block += s[offset:]
                if len(block) > 0:
                    missing = 1
            else:
                block += s[offset : offset + idx]
                offset += idx
                n = int(bytes(block))  # may raise ValueError
                block_len = n
                if block_len <= len(block):
                    raise ValueError("Block length too short")
                have_length = True
                missing = block_len - len(block)
        if have_length:
            s_len = len(s) - offset
            if missing <= s_len:
                block += s[offset : offset + missing]
                return bytes(block), block_len, 0
            block += s[offset:]
            missing -= s_len
        offset = 0
    return bytes(block), block_len, missing


class BlockParser:
    """(reference: testparsers/blockparser.go)."""

    def __init__(self, connection):
        self.connection = connection
        self.inserted = False

    def on_data(self, reply, end_stream, data):
        try:
            block, block_len, missing = get_block(data)
        except ValueError:
            return ERROR, int(OpError.ERROR_INVALID_FRAME_LENGTH)
        if self.inserted:
            self.inserted = False
            return DROP, block_len
        if missing == 0 and block_len == 0:
            return NOP, 0
        if b"PASS" in block:
            self.connection.log(EntryType.Request, proto="http", fields={"status": 200})
            return PASS, block_len
        if b"DROP" in block:
            self.connection.log(EntryType.Denied, proto="http", fields={"status": 201})
            return DROP, block_len
        if missing > 0:
            return MORE, missing
        if b"INJECT" in block:
            self.connection.inject(not reply, block)
            return DROP, block_len
        if b"INSERT" in block:
            self.connection.inject(reply, block)
            self.inserted = True
            return INJECT, block_len
        return ERROR, int(OpError.ERROR_INVALID_FRAME_TYPE)


class BlockParserFactory:
    def create(self, connection):
        return BlockParser(connection)


class HeaderRule:
    """prefix/contains/suffix rule on a whitespace-trimmed line
    (reference: testparsers/headerparser.go HeaderRule)."""

    def __init__(self, prefix=b"", contains=b"", suffix=b""):
        self.prefix, self.contains, self.suffix = prefix, contains, suffix

    def matches(self, data) -> bool:
        bs = bytes(data).strip()
        if self.prefix and not bs.startswith(self.prefix):
            return False
        if self.contains and self.contains not in bs:
            return False
        if self.suffix and not bs.endswith(self.suffix):
            return False
        return True


def header_rule_parser(rule_config):
    rules = []
    for kv in rule_config.l7_rules or []:
        hr = HeaderRule()
        for k, v in kv.items():
            if k == "prefix":
                hr.prefix = v.encode()
            elif k == "contains":
                hr.contains = v.encode()
            elif k == "suffix":
                hr.suffix = v.encode()
            else:
                parse_error(f"Unsupported key: {k}", rule_config)
        rules.append(hr)
    return rules


class HeaderParser:
    """(reference: testparsers/headerparser.go)."""

    def __init__(self, connection):
        self.connection = connection

    def on_data(self, reply, end_stream, data):
        line, ok = get_line(data)
        line_len = len(line)
        if not ok:
            if line_len > 0:
                return MORE, 1
            return NOP, 0
        if reply or self.connection.matches(line):
            self.connection.log(
                EntryType.Request,
                proto="test.headerparser",
                fields={"status": "PASS"},
            )
            return PASS, line_len
        self.connection.inject(not reply, b"Line dropped: " + line)
        self.connection.log(
            EntryType.Denied,
            proto="test.headerparser",
            fields={"status": "DROP"},
        )
        return DROP, line_len


class HeaderParserFactory:
    def create(self, connection):
        return HeaderParser(connection)


register_parser_factory("test.passer", PasserParserFactory())
register_parser_factory("test.lineparser", LineParserFactory())
register_parser_factory("test.blockparser", BlockParserFactory())
register_parser_factory("test.headerparser", HeaderParserFactory())
register_l7_rule_parser("test.headerparser", header_rule_parser)

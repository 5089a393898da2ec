"""r2d2 line-protocol parser — the minimum end-to-end protocol family.

A copy of ``cilium_tpu/proxylib/parsers/r2d2.py`` (reference:
proxylib/r2d2/r2d2parser.go): the rule matcher, its NPDS rule parser and
the streaming parser the sidecar's in-process oracle connections run.  Protocol:
  "READ <filename>\\r\\n" | "WRITE <filename>\\r\\n" | "HALT\\r\\n" | "RESET\\r\\n"
Rules are key/value pairs {cmd: exact, file: regex}; the ``file`` regex uses
search semantics (Go regexp.MatchString, reference: r2d2parser.go:79).

The rule matcher compiles ``file`` through ``cilium_tpu_torch.regex`` — the
SAME NFA the batch model's automaton is built from — so the host oracle and
the device path share one compiled semantics.
"""

from __future__ import annotations

from dataclasses import dataclass

from ...regex import CompiledPattern, compile_pattern, py_search
from ...regex.parse import ParseError as RegexParseError
from ..accesslog import EntryType
from ..parser import parse_error, register_l7_rule_parser, register_parser_factory
from ..types import DROP, ERROR, MORE, PASS, OpError

VALID_CMDS = ("READ", "WRITE", "HALT", "RESET")
FILE_CMDS = ("", "READ", "WRITE")


@dataclass
class R2d2RequestData:
    cmd: str
    file: str


class R2d2Rule:
    def __init__(self, cmd_exact: str = "", file_regex: str = ""):
        self.cmd_exact = cmd_exact
        self.file_regex = file_regex
        self.file_compiled: CompiledPattern | None = (
            compile_pattern(file_regex) if file_regex else None
        )

    def matches(self, data) -> bool:
        if not isinstance(data, R2d2RequestData):
            return False
        if self.cmd_exact and self.cmd_exact != data.cmd:
            return False
        if self.file_compiled is not None and not py_search(
            self.file_compiled, data.file.encode("utf-8", "surrogateescape")
        ):
            return False
        return True


def request_data(msg: bytes) -> R2d2RequestData:
    """Tokenize one framed message (CRLF stripped) the way the streaming
    parser does (reference: r2d2parser.go:169-175): ``msg.split(" ")``,
    the file only when there are exactly two fields."""
    fields = msg.decode("utf-8", "surrogateescape").split(" ")
    return R2d2RequestData(
        cmd=fields[0], file=fields[1] if len(fields) == 2 else ""
    )


def r2d2_rule_parser(rule_config):
    """(reference: r2d2parser.go:89-127, incl. validation)."""
    rules = []
    for kv in rule_config.l7_rules or []:
        cmd, file_ = "", ""
        for k, v in kv.items():
            if k == "cmd":
                cmd = v
            elif k == "file":
                file_ = v
            else:
                parse_error(f"Unsupported key: {k}", rule_config)
        if cmd and cmd not in VALID_CMDS:
            parse_error(
                f"Unable to parse L7 r2d2 rule with invalid cmd: '{cmd}'", rule_config
            )
        if file_ and cmd not in FILE_CMDS:
            parse_error(
                f"Unable to parse L7 r2d2 rule, cmd '{cmd}' is not compatible with 'file'",
                rule_config,
            )
        try:
            rules.append(R2d2Rule(cmd, file_))
        except RegexParseError as e:
            parse_error(f"invalid file regex: {e}", rule_config)
    return rules


class R2d2Parser:
    """(reference: r2d2parser.go:151-214)."""

    def __init__(self, connection):
        self.connection = connection

    def on_data(self, reply, end_stream, data):
        joined = b"".join(data)
        idx = joined.find(b"\r\n")
        if idx < 0:
            return MORE, 1
        msg = joined[:idx]
        msg_len = idx + 2

        if reply:
            return PASS, msg_len

        fields = msg.decode("utf-8", "surrogateescape").split(" ")
        if len(fields) == 0:
            return ERROR, int(OpError.ERROR_INVALID_FRAME_TYPE)
        file_ = fields[1] if len(fields) == 2 else ""
        req = R2d2RequestData(cmd=fields[0], file=file_)

        matches = self.connection.matches(req)
        self.connection.log(
            EntryType.Request if matches else EntryType.Denied,
            proto="r2d2",
            fields={"cmd": req.cmd, "file": req.file},
        )
        if not matches:
            self.connection.inject(True, b"ERROR\r\n")
            return DROP, msg_len
        return PASS, msg_len


class R2d2ParserFactory:
    def create(self, connection):
        return R2d2Parser(connection)


register_parser_factory("r2d2", R2d2ParserFactory())
register_l7_rule_parser("r2d2", r2d2_rule_parser)

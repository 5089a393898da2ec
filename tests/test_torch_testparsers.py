"""The port's test parsers (``proxylib/parsers/testparsers.py``) against the
reference's.

The cases of tests/test_proxylib.py that use a ``test.*`` parser run
through both packages' proxylib with the same connections, data and
policies; the op sequences, results, inject buffers and access-log counts
must be equal (tolerance 0) and equal to the reference test's
expectations.  Then a ``test.lineparser`` conn through each package's
``VerdictService`` on the CPU, driven by each package's
``SidecarClient``, gives equal outputs.
"""

from __future__ import annotations

import importlib
import itertools
from types import SimpleNamespace

import pytest

from policy_cases import reference_leak_guard  # noqa: F401 (a module fixture)


def _proxylib(pkg):
    ns = SimpleNamespace(name=pkg, pl=importlib.import_module(f"{pkg}.proxylib"),
                         types=importlib.import_module(f"{pkg}.proxylib.types"),
                         inst=importlib.import_module(f"{pkg}.proxylib.instance"),
                         http=importlib.import_module(f"{pkg}.proxylib.parsers.http"),
                         option=importlib.import_module(f"{pkg}.utils.option"),
                         service=importlib.import_module(f"{pkg}.sidecar.service"),
                         client=importlib.import_module(f"{pkg}.sidecar.client"))
    ns.cfg_kw = {"verdict_device": "cpu"} if pkg == "cilium_tpu_torch" else {}
    return ns


PKGS = {"ref": _proxylib("cilium_tpu"), "port": _proxylib("cilium_tpu_torch")}
_ids = itertools.count(1)


@pytest.fixture(autouse=True)
def fresh_registry():
    for pk in PKGS.values():
        pk.pl.reset_module_registry()
    yield
    for pk in PKGS.values():
        pk.pl.reset_module_registry()


def both(scenario):
    """``scenario(pk)`` through each package; the results must be equal.
    Returns the reference's."""
    out = {name: scenario(pk) for name, pk in PKGS.items()}
    assert out["port"] == out["ref"]
    return out["ref"]


def _mod(pk):
    mod = pk.pl.open_module([], True)
    assert mod != 0
    return mod


def _conn(pk, mod, proto, policy_name, buf_size=1024, dst="2.2.2.2:80"):
    """(result, connection) of a new ingress connection from identity 1."""
    res, conn = pk.inst.on_new_connection(mod, proto, next(_ids), True, 1, 2, "1.1.1.1:34567", dst, policy_name,
                                          orig_buf_capacity=buf_size, reply_buf_capacity=buf_size)
    return int(res), conn


def _data(conn, data, reply=False, end_stream=False):
    """(result, ops, reply inject) of one OnData call, as tests/
    proxylib_harness.py's check_on_data reads them."""
    ops = []
    res = conn.on_data(reply, end_stream, data, ops)
    return int(res), [(int(op), int(n)) for op, n in ops], conn.reply_buf.take()


def _counts(pk, mod):
    return pk.pl.find_instance(mod).access_logger.counts()


def _policy(pk, name, rules, port=80):
    return pk.pl.NetworkPolicy(name=name, policy=2,
                               ingress_per_port_policies=[pk.pl.PortNetworkPolicy(port=port, rules=rules)])


HEADER_LINES = [b"Beginning----\n", b"foo\n", b"----End\n", b"\n"]


def _header_run(pk, rules):
    mod = _mod(pk)
    if rules is not None:
        pk.pl.find_instance(mod).policy_update([_policy(pk, "FooBar", rules(pk))])
    res, conn = _conn(pk, mod, "test.headerparser", "FooBar", buf_size=80)
    return res, _data(conn, [b"".join(HEADER_LINES)]), _counts(pk, mod)


def _ops(*pairs):
    return [(int(op), n) for op, n in pairs]


# --- the cases ------------------------------------------------------------------


def _on_new_connection_errors(pk):
    mod = _mod(pk)
    out = [_conn(pk, mod, "invalid-parser", "policy-1")[0]]
    for dst in ("2.2.2.2:XYZ", "2.2.2.2", "2.2.2.2:0"):
        out.append(_conn(pk, mod, "test.passer", "policy-1", dst=dst)[0])
    out.append(_conn(pk, mod, "test.passer", "invalid-policy")[0])
    res, conn = _conn(pk, mod, "test.passer", "policy-1")
    return out + [res, conn is not None]


def test_on_new_connection_errors_match_reference():
    fr = PKGS["ref"].pl.FilterResult
    assert both(_on_new_connection_errors) == [
        int(fr.UNKNOWN_PARSER), int(fr.INVALID_ADDRESS), int(fr.INVALID_ADDRESS), int(fr.INVALID_ADDRESS),
        int(fr.POLICY_DROP), int(fr.OK), True]


def _on_data_no_policy(pk):
    mod = _mod(pk)
    res, conn = _conn(pk, mod, "test.headerparser", "policy-1", buf_size=30)
    line1, line2, line3 = b"No policy\n", b"Dropped\n", b"foo"
    return (res, _data(conn, [line1, line2 + line3]), _data(conn, [line3]), _data(conn, []), _counts(pk, mod))


def test_on_data_no_policy_matches_reference():
    t = PKGS["ref"].types
    res, first, second, third, counts = both(_on_data_no_policy)
    assert res == 0 and counts == (0, 2)
    assert first == (0, _ops((t.DROP, 10), (t.DROP, 8), (t.MORE, 1)),
                     (b"Line dropped: No policy\nLine dropped: Dropped\n")[:30])
    assert second == (0, _ops((t.MORE, 1)), b"") and third == (0, [], b"")


class _PanicParser:
    def on_data(self, reply, end_stream, data):
        if not reply:
            raise RuntimeError("panicing...")
        return 0, 0


class _PanicParserFactory:
    def create(self, connection):
        return _PanicParser()


def _on_data_panic(pk):
    pk.pl.register_parser_factory("test.panicparser", _PanicParserFactory())
    mod = _mod(pk)
    res, conn = _conn(pk, mod, "test.panicparser", "policy-1", buf_size=30)
    return res, _data(conn, [b"foo"]), _counts(pk, mod)


def test_on_data_panic_matches_reference():
    fr = PKGS["ref"].pl.FilterResult
    assert both(_on_data_panic) == (0, (int(fr.PARSER_ERROR), [], b""), (0, 1))


def test_unsupported_l7_drops_matches_reference():
    t = PKGS["ref"].types
    res, got, counts = both(lambda pk: _header_run(pk, lambda pk: [
        pk.pl.PortNetworkPolicyRule(remote_policies=[1, 3], l7_proto="unknown-l7", l7_rules=[])]))
    assert res == 0 and counts == (0, 4)
    assert got == (0, _ops(*((t.DROP, len(ln)) for ln in HEADER_LINES)),
                   b"".join(b"Line dropped: " + ln for ln in HEADER_LINES)[:80])  # the buffer's capacity


def _header_rules(pk):
    return [pk.pl.PortNetworkPolicyRule(remote_policies=[1, 3, 4], l7_proto="test.headerparser",
                                        l7_rules=[{"prefix": "Beginning"}, {"suffix": "End"}])]


def test_two_rules_same_port_first_no_l7_matches_reference():
    t = PKGS["ref"].types
    l1, l2, l3, l4 = HEADER_LINES
    res, got, counts = both(lambda pk: _header_run(
        pk, lambda pk: [pk.pl.PortNetworkPolicyRule(remote_policies=[11])] + _header_rules(pk)))
    assert res == 0 and counts == (2, 2)
    assert got == (0, _ops((t.PASS, len(l1)), (t.DROP, len(l2)), (t.PASS, len(l3)), (t.DROP, len(l4))),
                   b"Line dropped: " + l2 + b"Line dropped: " + l4)


def _mismatching_l7_types(pk):
    """A dummy HTTP rule parser is registered, as the reference test does,
    and the real one put back after."""
    pk.pl.register_l7_rule_parser("http", lambda rule_config: [])
    try:
        mod = _mod(pk)
        ins = pk.pl.find_instance(mod)
        try:
            ins.policy_update([_policy(pk, "FooBar", [
                pk.pl.PortNetworkPolicyRule(remote_policies=[11], http_rules=[
                    {"headers": [{"name": ":path", "exact_match": "/allowed"}]}]),
                pk.pl.PortNetworkPolicyRule(remote_policies=[1], l7_proto="test.headerparser",
                                            l7_rules=[{"prefix": "Beginning"}])])])
        except pk.pl.PolicyParseError:
            raised = True
        else:
            raised = False
        return raised, ins.has_policy("FooBar")
    finally:
        pk.pl.register_l7_rule_parser("http", pk.http.http_rule_parser)


def test_mismatching_l7_types_rejected_matches_reference():
    assert both(_mismatching_l7_types) == (True, False)


def test_simple_policy_pass_drop_matches_reference():
    t = PKGS["ref"].types
    l1, l2, l3, l4 = HEADER_LINES
    res, got, counts = both(lambda pk: _header_run(pk, _header_rules))
    assert res == 0 and counts == (2, 2)
    assert got == (0, _ops((t.PASS, len(l1)), (t.DROP, len(l2)), (t.PASS, len(l3)), (t.DROP, len(l4))),
                   b"Line dropped: " + l2 + b"Line dropped: " + l4)


def test_allow_all_policy_matches_reference():
    t = PKGS["ref"].types
    res, got, counts = both(lambda pk: _header_run(pk, lambda pk: [pk.pl.PortNetworkPolicyRule(
        remote_policies=[1, 3, 4], l7_proto="test.headerparser", l7_rules=[])]))
    assert res == 0 and counts == (4, 0)
    assert got == (0, _ops(*((t.PASS, len(ln)) for ln in HEADER_LINES)), b"")


def _wrong_remote(pk):
    mod = _mod(pk)
    pk.pl.find_instance(mod).policy_update([_policy(pk, "FooBar", [pk.pl.PortNetworkPolicyRule(
        remote_policies=[11], l7_proto="test.headerparser", l7_rules=[{"prefix": "B"}])])])
    res, conn = _conn(pk, mod, "test.headerparser", "FooBar", buf_size=80)
    return res, _data(conn, [HEADER_LINES[0]])


def test_wrong_remote_id_drops_matches_reference():
    t = PKGS["ref"].types
    l1 = HEADER_LINES[0]
    assert both(_wrong_remote) == (0, (0, _ops((t.DROP, len(l1))), b"Line dropped: " + l1))


def _line_parser(pk):
    mod = _mod(pk)
    res, conn = _conn(pk, mod, "test.lineparser", "p", buf_size=80)
    first = _data(conn, [b"PASS line\n", b"DROP this\n", b"partial"])
    second = _data(conn, [b"INJECT me\n"])
    third = _data(conn, [b"INSERT x\n"])
    return res, first, second, third, conn.orig_buf.take()


def test_line_parser_ops_match_reference():
    t = PKGS["ref"].types
    res, first, second, third, orig = both(_line_parser)
    assert res == 0 and first == (0, _ops((t.PASS, 10), (t.DROP, 10), (t.MORE, 1)), b"")
    assert second == (0, _ops((t.DROP, 10)), b"INJECT me\n")
    assert third == (0, _ops((t.INJECT, 9), (t.DROP, 9)), b"") and orig == b"INSERT x\n"


def _block_parser(pk):
    mod = _mod(pk)
    res, conn = _conn(pk, mod, "test.blockparser", "p", buf_size=80)
    return (res, _data(conn, [b"7:PASS!9:DROP1234"]), _data(conn, [b"2"]), _data(conn, []),
            _data(conn, [b"XYZ:foo"]))


def test_block_parser_ops_match_reference():
    t = PKGS["ref"].types
    res, first, second, third, bad = both(_block_parser)
    assert res == 0 and first == (0, _ops((t.PASS, 7), (t.DROP, 9), (t.MORE, 1)), b"")
    assert second == (0, _ops((t.MORE, 1)), b"") and third == (0, [], b"")
    assert bad == (0, [(int(t.ERROR), int(t.OpError.ERROR_INVALID_FRAME_LENGTH))] * 16, b"")


# --- a test.lineparser conn through each package's verdict service ----------------


def _service_lineparser(pk, tmp_path):
    root = tmp_path / pk.name
    root.mkdir()
    svc = pk.service.VerdictService(str(root / "vs.sock"),
                                    pk.option.DaemonConfig(batch_timeout_ms=2.0, **pk.cfg_kw)).start()
    client = pk.client.SidecarClient(svc.socket_path)
    try:
        mod = client.open_module([])
        res, shim = client.new_connection(mod, "test.lineparser", 41, True, 1, 2, "1.1.1.1:34567", "2.2.2.2:80",
                                          "policy-1")
        out = [res]
        if shim is not None:
            for chunk in (b"PASS line\n", b"DROP this\n", b"INJECT me\n", b"INSERT x\n", b"half", b" line\n"):
                out.append(shim.on_io(False, chunk))
            out.append(shim.on_io(True, b""))
        return out
    finally:
        client.close()
        svc.stop()


def test_lineparser_through_the_verdict_service_matches_reference(tmp_path):
    out = both(lambda pk: _service_lineparser(pk, tmp_path))
    assert out[0] == int(PKGS["ref"].pl.FilterResult.OK) and len(out) == 8
    assert out[1][1] == b"PASS line\n" and out[2][1] == b""

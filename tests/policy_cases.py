"""Both packages' policy planes side by side, for the parity tests of
tests/test_torch_{policy,builder,proxy,monitor}.py.

``PKGS["ref"]`` and ``PKGS["port"]`` name each package's labels, policy,
builder and proxy modules under the same attributes, so one test body
runs on either.  ``world(pk, ...)`` loads the same JSON rule document
(``cilium_tpu_torch.entry.policy_rules``, the policy slice's generator)
and the same identity label strings into one package; the ``canon_*``
functions turn a resolution into plain dicts that compare across the two.
A test module imports ``reference_leak_guard`` to guard itself against
the reference tests' leaks.
"""

from __future__ import annotations

import json
from types import SimpleNamespace

import pytest

import cilium_tpu.labels as ref_labels
import cilium_tpu.labels.cidr as ref_cidr
import cilium_tpu.models.builder as ref_builder
import cilium_tpu.policy as ref_policy
import cilium_tpu.policy.api as ref_api
import cilium_tpu.policy.l4 as ref_l4
import cilium_tpu.proxy as ref_proxy
import cilium_tpu.proxy.npds_push as ref_npds_push
import cilium_tpu_torch.labels as port_labels
import cilium_tpu_torch.labels.cidr as port_cidr
import cilium_tpu_torch.models.builder as port_builder
import cilium_tpu_torch.policy as port_policy
import cilium_tpu_torch.policy.api as port_api
import cilium_tpu_torch.policy.l4 as port_l4
import cilium_tpu_torch.proxy as port_proxy
import cilium_tpu_torch.proxy.npds_push as port_npds_push
from cilium_tpu_torch import entry

PKGS = {
    "ref": SimpleNamespace(name="ref", labels=ref_labels, cidr=ref_cidr, policy=ref_policy,
                           api=ref_api, l4=ref_l4, builder=ref_builder, proxy=ref_proxy,
                           npds_push=ref_npds_push),
    "port": SimpleNamespace(name="port", labels=port_labels, cidr=port_cidr, policy=port_policy,
                            api=port_api, l4=port_l4, builder=port_builder, proxy=port_proxy,
                            npds_push=port_npds_push),
}


@pytest.fixture(autouse=True, scope="module")
def reference_leak_guard():
    """Reference tests leave a dummy HTTP/DNS rule parser registered and a
    FlightRecorder installed (ROADMAP Queue 3): put the real parsers back
    and uninstall every recorder, before and after a module that imports
    this fixture."""
    from cilium_tpu.proxylib.parser import register_l7_rule_parser
    from cilium_tpu.proxylib.parsers.dns import dns_rule_parser
    from cilium_tpu.proxylib.parsers.http import http_rule_parser
    from cilium_tpu.sidecar import blackbox as ref_bb
    from cilium_tpu_torch.sidecar import blackbox as port_bb

    def clean():
        register_l7_rule_parser("http", http_rule_parser)
        register_l7_rule_parser("dns", dns_rule_parser)
        for bb in (ref_bb, port_bb):
            for rec in list(bb._RECORDERS):
                rec.uninstall()

    clean()
    yield
    clean()


def world(pk, n_rules=120, seed=5, broad=0.35):
    """(identity cache {numeric: Labels}, Repository) of ``pk`` from the
    policy slice's generator: the same label strings and JSON document
    for either package."""
    cache = {n: pk.labels.Labels.from_model(lbls) for n, lbls in entry.policy_identities().items()}
    repo = pk.policy.Repository()
    for rule in pk.policy.rules_from_json(json.dumps(entry.policy_rules(n_rules, seed, broad))):
        repo.add(rule)
    return cache, repo


def ctx_to(pk, cache, numeric, dports=()):
    return pk.policy.SearchContext(to_labels=cache[numeric].to_array(),
                                   dports=[pk.policy.DPort(p, "TCP") for p in dports])


def canon_l7(l7) -> dict:
    return {
        "http": [h.key() for h in l7.http],
        "kafka": [(k.key(), tuple(k.api_keys_int), k.api_version_int) for k in l7.kafka],
        "l7proto": l7.l7proto,
        "l7": [r.key() for r in l7.l7],
    }


def canon_filter(f) -> dict:
    """An L4Filter as plain data, the L7 map in its insertion order (the
    order decides the first rule a model attributes a verdict to)."""
    return {
        "port": f.port, "protocol": f.protocol, "u8_proto": f.u8_proto,
        "endpoints": [str(s) for s in f.endpoints], "l7_parser": f.l7_parser,
        "ingress": f.ingress,
        "l7": [(str(s), canon_l7(l7)) for s, l7 in f.l7_rules_per_ep.items()],
        "derived": [list(a.get_model()) for a in f.derived_from_rules],
    }


def canon_l4(m) -> dict:
    return {k: canon_filter(f) for k, f in m.items()}


def canon_cidr(cp) -> dict:
    return {"model": cp.get_model(), "lpm": cp.to_lpm_data()}


def remote_rows(rows) -> list:
    """(remotes, rule key) pairs of the builder's rows."""
    return [(sorted(rs), r.key()) for rs, r in rows]

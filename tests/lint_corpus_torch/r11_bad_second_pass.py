"""KNOWN-BAD corpus: fused-attribution integrity — three shapes of
"attribution pays a second device pass": the attr twin calling the
plain twin, twins on DIVERGED hit helpers, and the shared helper
invoked twice."""

import torch


def _toy_rule_hits(model, data):
    return data @ model


def toy_verdicts(model, data):
    hits = _toy_rule_hits(model, data)
    return torch.any(hits, dim=1)


def toy_verdicts_attr(model, data):  # EXPECT[R11]
    allow = toy_verdicts(model, data)
    hits = _toy_rule_hits(model, data)
    return allow, torch.argmax(hits, dim=1)


def _hits_a(model, data):
    return data @ model


def _hits_b(model, data):
    return (data + 1) @ model


def fan_verdicts(model, data):
    return torch.any(_hits_a(model, data), dim=1)


def fan_verdicts_attr(model, data):  # EXPECT[R11]
    h = _hits_b(model, data)
    return torch.any(h, dim=1), torch.argmax(h, dim=1)


def twice_verdicts(model, data):
    return torch.any(_hits_a(model, data), dim=1)


def twice_verdicts_attr(model, data):  # EXPECT[R11]
    allow = torch.any(_hits_a(model, data), dim=1)
    rule = torch.argmax(_hits_a(model, data), dim=1)
    return allow, rule

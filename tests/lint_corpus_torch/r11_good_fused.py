"""KNOWN-GOOD corpus for R11: one shared hit-matrix pass, two
reductions — the PR 5 fused-attribution design."""

import torch


def _toy_rule_hits(model, data):
    return data @ model


def toy_verdicts(model, data):
    hits = _toy_rule_hits(model, data)
    return torch.any(hits, dim=1)


def toy_verdicts_attr(model, data):
    hits = _toy_rule_hits(model, data)
    allow = torch.any(hits, dim=1)
    return allow, torch.where(allow, torch.argmax(hits, dim=1), -1)

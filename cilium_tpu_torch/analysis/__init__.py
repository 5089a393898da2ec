"""cilium-lint for the port: AST-based concurrency & hot-path invariant
analysis, with torch forms of its device rules.

The rules are machine-checked invariants over the package's own AST
(stdlib ``ast`` only, no third-party linter):

  R1  lock discipline (acquire/finally pairing, captured-binding
      release, WHOLE-PROGRAM lock-order graph incl. call-mediated
      cross-module inversions)
  R2  blocking calls inside a held-lock region, incl. blocking
      reached THROUGH helper chains (interprocedural taint)
  R3  socket close() with no dominating shutdown()
  R4  purity of functions reached from a CUDA-graph capture
      (``torch.cuda.graph`` blocks, the functions ``_CudaGraphFn`` /
      ``_jit_for`` capture, the ``models/`` entry points they wrap)
  R5  wire MSG_* / FilterResult handler exhaustiveness + field-level
      JSON payload symmetry (MSG_TRACE/MSG_OBSERVE request & reply)
  R6  thread hygiene (Thread() without daemon= or local join)
  R7  metric hygiene (dead registrations, hot-loop observes)
  R8  capture hazards in capture-reached code (host-read scalars,
      data-dependent shapes, dtype-less scalar tensors)
  R9  implicit host transfers (.item()/.cpu()/.tolist()/.numpy()/
      synchronize in captured code; a model output read outside
      ``_to_host`` on the dispatch hot path)
  R10 per-slot fan-out arity (each mesh slot's step is passed the
      arguments it takes)
  R11 fused-attribution integrity (one shared hit-matrix pass)
  R12 compile-on-dispatch-path (captures, nvcc builds and engine
      builds ride the builder thread)
  R13 epoch-unkeyed caches in hot modules
  R14 exactly-once verdict accounting (admit paths reach an answer
      site or typed hand-off; answer sites are exclusivity-guarded)
  R15 exception containment (no raise out of a per-entry hot loop
      without a typed outcome; interprocedural raise-taint)
  R16 graph shape-closure (dispatch axes drawn from the declared
      power-of-two bucket universe; the device twin audits the real
      serving surface end to end)
  R17 snapshot round-trip symmetry (snapshot_*/restore_* pairs)
  R18 declared typestates (every state-field store is a declared
      protocols.py edge, mediated through advance/guard/
      require_edges; every counted edge's site emits its declared
      metric token; the table itself is well-formed)
  R19 column-store lock discipline (declared shared numpy column
      families written only with the owning lock held; multi-column
      snapshots read in ONE lock trip)
  R20 wire-protocol lifecycle (each MSG_* matches its declared
      direction, request/reply pairing, fire-and-forget and gate
      rows; native-shim header enum values stay bit-identical)
  R21 parity-coverage registry (every runtime-registered framing
      family carries its full declared landing bar)
  R22 fail-closed recorder coverage (every FAIL_CLOSED row reaches a
      flight-recorder emit site)
  R23 unledgered compile site (every nvcc build, capture and engine
      build reachable from the dispatch or policy-builder roots routes
      through the device-economics ledger)
  R0  lint pragma hygiene (malformed / unjustified suppressions)

Layer 1 is the interprocedural engine (``callgraph.py``): a project-
wide call graph with import/attribute resolution, per-function
blocking/lock summaries and a fixed-point taint pass.  Layer 2 is the
device-contract pair: ``rules_device.py`` (AST half) and
``devicecheck.py``, which records the ordered op trace of one call of
each real verdict model — through a recorder around the kernel-holding
ops on the CPU, through ``kernels.captured_by`` around a real
``torch.cuda.graph`` capture on the card — and checks R8-R11 and the
R16 shape closure on those traces.  Layer 3 is the declared-protocol
module (``protocols.py``): typestate transition tables, column-store
families, wire lifecycle rows and engine landing bars as DATA, which
the sidecar imports and enforces at run time while
``rules_typestate`` / ``rules_columns`` / ``rules_protocol`` /
``rules_parity`` prove the tree against the SAME tables.

Run ``python -m cilium_tpu_torch.analysis.cli`` (default path
``cilium_tpu_torch``, default baseline ``tests/lint_baseline_torch.json``);
``--ratchet`` gates the suppression count one-way downward,
``--device-contracts`` adds the device layer (on the card; ``--device
cpu`` for the CPU op traces), ``--diff <rev>`` scans changed files only
and ``--sarif`` emits SARIF 2.1.0 for CI annotation.  Suppress a false
positive on its line with a JUSTIFIED pragma::

    risky_call()  # lint: disable=R2 -- why this is safe here

A pragma without a justification is itself a finding (R0) and cannot
be suppressed.  Nothing here imports torch but ``devicecheck.py``.
"""

from .core import (  # noqa: F401
    Finding,
    RULE_DOCS,
    SourceFile,
    analyze_paths,
    findings_to_json,
    load_baseline,
    load_baseline_full,
    split_findings,
)

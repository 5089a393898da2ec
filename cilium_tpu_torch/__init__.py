"""PyTorch + CUDA port of ``cilium_tpu``'s device paths: the r2d2, HTTP,
DNS, Cassandra, memcached and Kafka L7 verdict paths below, the L3/L4
datapath (``datapath/``) and the sidecar verdict service (``sidecar/``).

The JAX package stays the reference; this package imports neither JAX nor
anything of ``cilium_tpu``.  Where it needs one of that package's jax-free
modules it keeps its own copy at the same relative path.

Path: NPDS ``NetworkPolicy`` -> ``proxylib.policy.compile_policy`` ->
``models.r2d2.build_r2d2_model`` (automaton tables on the card) ->
``models.r2d2.r2d2_verdicts`` (kernels K1 frame, K2/K3 automaton scan,
K4 rule hits) -> ``runtime.batch.R2d2BatchEngine`` PASS/DROP/MORE ops.

HTTP: NPDS ``http_rules`` -> ``models.http.build_http_model_for_port`` ->
``models.http.http_verdicts`` (kernels K5 head framing, K6 literal tier,
K2/K3 on the regex spans, K7 rule hits) ->
``runtime.engines.HttpBatchEngine`` PASS/DROP ops with 403 injects.

DNS: NPDS ``l7_proto: "dns"`` -> ``models.dns.build_dns_model`` ->
``models.dns.dns_verdicts`` (kernels K8 frame and QNAME walk, K2/K3 on the
dotted name, K9 rule hits) -> ``runtime.dnsengine.DnsBatchEngine``.
Cassandra and memcached: ``models.cassandra`` / ``models.memcached``
(K2/K3 on the table or key span, K10 / K11 ACL) ->
``runtime.l7engine.CassandraBatchEngine`` / ``MemcacheBatchEngine``, whose
streaming parsers take their verdicts from the device;
``runtime.l7engine.HttpSidecarEngine`` runs HTTP through the same base.

Kafka: sanitized ``policy.api.PortRuleKafka`` rows ->
``models.kafka.build_kafka_model`` -> ``models.kafka.kafka_verdicts`` over
``encode_requests`` of parsed requests (kernel K17 topic ACL) ->
``runtime.engines.KafkaBatchEngine`` PASS/DROP ops with error-response
injects.  Long frames: ``ops.seqdfa.device_dfa_absorbing`` ->
``ops.seqdfa.seqdfa_search_batch`` (kernel K18: chunk fold, then apply).

Entry points take ``device=None``, which means the CUDA card; they raise if
there is none.  The CPU runs the kernels' plain PyTorch versions and is
used only when the caller passes ``device="cpu"``.
"""

from .device import resolve_device

__all__ = ["resolve_device"]

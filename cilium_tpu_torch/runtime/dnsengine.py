"""DNS batch engine — the first length-prefixed family on the engine rung.

Counterpart of ``cilium_tpu/runtime/dnsengine.py`` with the port's DNS
model inside (``models/dns.py``: kernels K8 and K9, K2/K3 on the dotted
name).  Reuses the whole ``R2d2BatchEngine`` machinery (feed/feed_extract/
settle_entry/pump) with the framing hooks rebound to DNS-over-TCP: frames
split on the 2-byte big-endian length prefix, the judged message is the
WHOLE prefixed frame, and denied frames inject nothing (a synthesized DNS
response would need the query id echoed per frame — see
proxylib/parsers/dns.py).  ``reasm_spec`` names the sidecar's columnar
twin of that framing (``sidecar/reasm.py`` FRAMINGS["dns"]).
"""

from __future__ import annotations

from ..proxylib.accesslog import EntryType, LogEntry
from ..proxylib.parsers.dns import frame_len, parse_dns_query
from .batch import FlowState, R2d2BatchEngine


class DnsBatchEngine(R2d2BatchEngine):
    """Batch engine for the DNS name-policy model (models/dns.py)."""

    proto = "dns"

    reasm_columnar = True

    @staticmethod
    def reasm_spec() -> str:
        """Columnar feed contract framing kind (reasm.FRAMINGS):
        DNS-over-TCP frames on a 2-byte big-endian length prefix."""
        return "dns"

    # Denied queries DROP with no reply inject (module docstring).
    DENY_INJECT = b""

    @staticmethod
    def _frame_split(buf) -> int:
        need = frame_len(bytes(buf[:2]))
        return need if 0 <= need <= len(buf) else -1

    @staticmethod
    def _frame_msg(buf, msg_len: int) -> bytes:
        """The judged message IS the whole prefixed frame (the device
        model reads the prefix itself)."""
        return bytes(buf[:msg_len])

    @staticmethod
    def frame_row(msg: bytes) -> bytes:
        """feed_extract messages already carry the full frame."""
        return msg

    def _log_frame(self, st: FlowState, msg: bytes, allow: bool) -> None:
        name = parse_dns_query(msg)
        self.logger.log(
            LogEntry(
                is_ingress=st.ingress,
                entry_type=EntryType.Request if allow else EntryType.Denied,
                policy_name=st.policy_name,
                source_security_id=st.remote_id,
                destination_security_id=st.dst_id,
                source_address=st.src_addr,
                destination_address=st.dst_addr,
                proto="dns",
                fields={"query": name if name is not None else "<invalid>"},
            )
        )

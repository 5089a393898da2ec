"""Centralized defaults (reference: pkg/defaults/defaults.go)."""

from __future__ import annotations

# Runtime paths
RUNTIME_PATH = "/var/run/cilium-tpu"
STATE_DIR = "state"
SOCK_PATH = RUNTIME_PATH + "/cilium-tpu.sock"
MONITOR_SOCK_PATH = RUNTIME_PATH + "/monitor.sock"
ACCESS_LOG_SOCK_PATH = RUNTIME_PATH + "/access_log.sock"

# Proxy port allocation range (reference: daemon/daemon.go:1327).
PROXY_PORT_MIN = 10000
PROXY_PORT_MAX = 20000

# Identity (reference: pkg/identity minimal user identity).
MIN_USER_IDENTITY = 256
MAX_IDENTITY = (1 << 24) - 1

# Cluster
CLUSTER_NAME = "default"

# Endpoint builders (reference: daemon/daemon.go:1623 — min 4 or NumCPU).
MIN_ENDPOINT_BUILDERS = 4

# Device batch defaults (TPU runtime, not in the reference).
BATCH_FLOWS = 2048
BATCH_WIDTH = 256
BATCH_TIMEOUT_MS = 0.5  # adaptive batching deadline toward <1ms p99

# Monitor
MONITOR_QUEUE_SIZE = 65536

# kvstore
KVSTORE_LEASE_TTL = 15.0  # seconds
KVSTORE_STALE_LOCK_TIMEOUT = 30.0

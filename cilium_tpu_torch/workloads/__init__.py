"""Container-runtime integration (reference: pkg/workloads)."""

from .runtime import (  # noqa: F401
    Workload,
    WorkloadRuntime,
    get_runtime,
    register_runtime,
    registered_runtimes,
)
from .watcher import EventType, WorkloadWatcher  # noqa: F401

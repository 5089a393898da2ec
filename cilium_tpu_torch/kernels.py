"""Build and bind the hand-written CUDA kernels in ``csrc/``.

Each ``csrc/<name>.cu`` exposes a plain C launcher that takes device
pointers and a stream and returns ``cudaGetLastError()``.  On first use,
one ``nvcc`` per source is started, all together, each into its own shared
library under ``_build/`` (named by a hash of the sources and flags, so an
edited source rebuilds); the libraries are loaded with ``ctypes``.  Nothing
here runs at import, so every module imports where there is no ``nvcc``
(the CPU tests import them all).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np
import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

# Guards the library cache and every kernel's launch counters.
_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# Every CudaKernel, in creation order.
ALL: list["CudaKernel"] = []


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest(src: Path) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for dep in [src, *sorted(CSRC.glob("*.cuh"))]:
        h.update(dep.read_bytes())
    return h.hexdigest()[:12]


def library_path(src: Path) -> Path:
    return BUILD / f"{src.stem}-{_digest(src)}.so"


def ptxas_log(src: Path) -> Path:
    return library_path(src).with_suffix(".ptxas.txt")


def build_all() -> dict[str, Path]:
    """Compile every source whose library is missing, one ``nvcc`` each,
    all started together; raises with the compiler's output on failure.
    Returns {stem: library path}."""
    BUILD.mkdir(parents=True, exist_ok=True)
    todo = [s for s in sources() if not library_path(s).exists()]
    procs = []
    for src in todo:
        tmp = library_path(src).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)]
        procs.append((src, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    failed = []
    for src, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{src.name}:\n{out}")
            tmp.unlink(missing_ok=True)
            continue
        ptxas_log(src).write_text(out)
        os.replace(tmp, library_path(src))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return {s.stem: library_path(s) for s in sources()}


def library(stem: str) -> ctypes.CDLL:
    with _lock:
        lib = _libs.get(stem)
        if lib is None:
            paths = build_all()
            for name, path in paths.items():
                _libs.setdefault(name, ctypes.CDLL(str(path)))
            lib = _libs[stem]
    return lib


def add_replays(held: list[tuple["CudaKernel", int]]) -> None:
    """Count one replay of a graph that holds ``held`` (``captured_by``'s
    pairs) in each kernel's ``replayed``, under the counters' lock."""
    with _lock:
        for k, n in held:
            k.replayed += n


def captured_by(fn) -> list[tuple["CudaKernel", int]]:
    """Run ``fn`` (a CUDA graph capture) and return the kernel launches
    it recorded, as (kernel, count) pairs: what one replay launches."""
    before = [k.captured for k in ALL]
    fn()
    return [(k, k.captured - n) for k, n in zip(ALL, before) if k.captured > n]


class CudaKernel:
    """One C launcher of a ``csrc/*.cu`` library.

    ``launches`` counts successful launches and nothing else, so a run
    can show that its path went through the kernel.  A call made while
    the stream is being captured into a CUDA graph launches nothing: it
    counts in ``captured`` instead.  The graph's replays launch the
    kernel without this wrapper; whoever replays a graph adds the
    launches the graph holds to ``replayed`` (see ``captured_by``).
    Every instance is listed in ``ALL``.  Arguments are passed as ``ctypes``
    values: ``c_void_p`` for every pointer and the stream, ``c_int`` for
    sizes."""

    def __init__(self, stem: str, symbol: str, argtypes: list):
        self.stem = stem
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self.captured = 0
        self.replayed = 0
        self._fn = None
        ALL.append(self)

    def _bind(self):
        if self._fn is None:
            lib = library(self.stem)
            fn = getattr(lib, self.symbol)
            fn.argtypes = [*self.argtypes, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            lib.cilium_error_string.argtypes = [ctypes.c_int]
            lib.cilium_error_string.restype = ctypes.c_char_p
            self._err = lib.cilium_error_string
            self._fn = fn
        return self._fn

    def launch(self, device: torch.device, *args) -> None:
        fn = self._bind()
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            capturing = torch.cuda.is_current_stream_capturing()
            err = fn(*args, stream)
        if err != 0:
            raise RuntimeError(
                f"{self.symbol}: CUDA error {err} "
                f"({self._err(err).decode()})"
            )
        # Under the lock: two threads launching at once must not lose a count.
        with _lock:
            if capturing:
                self.captured += 1
            else:
                self.launches += 1


def check(t, name: str, dtype: torch.dtype, shape: tuple, device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape``
    (``None`` matches any extent) on ``device``: the kernels take nothing
    else."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != len(shape) or any(
        want is not None and got != want for got, want in zip(t.shape, shape)
    ):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: expected device {device}, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def arg(x, name: str, dtype: torch.dtype, shape: tuple, device: torch.device) -> torch.Tensor:
    """``x`` as a kernel argument: host data (a numpy array or a list) is
    copied to ``device`` as ``dtype``; a tensor must already be what the
    kernel takes (see ``check``) and is never copied or converted."""
    if not isinstance(x, torch.Tensor):
        # lint: disable=R9 -- host inputs only: a captured call passes tensors, which skip this copy
        x = torch.from_numpy(np.ascontiguousarray(x)).to(device=device, dtype=dtype)
    check(x, name, dtype, shape, device)
    return x


def frame_variant(stem: str, data: torch.Tensor) -> tuple[int, int, bool]:
    """(lanes a row, 16-byte chunks a lane a step, 16-byte loads) that the
    framing launcher of ``csrc/<stem>.cu`` (K1 ``r2d2_frame``, K5
    ``http_frame``; ``csrc/frame_scan.cuh``) takes for ``data`` [F, L]."""
    fn = library(stem).frame_variant
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    v = fn(data.shape[1], data.shape[0], data.data_ptr())
    return v & 0xFF, (v >> 8) & 0xFF, bool(v >> 16)


def hits_variant(stem: str, r: int, f: int) -> tuple[int, int]:
    """(lanes a flow, rows a lane a step) that the rule-walk launcher of
    ``csrc/<stem>.cu`` (K4 ``r2d2_hits``, K9 ``dns_hits``, K10
    ``cassandra_hits``, K11 ``memcache_hits``; ``csrc/rule_walk.cuh``)
    takes for ``r`` rule rows and ``f`` flows; (0, 0) is K10's and K11's
    direct walk, a thread a request with no staging
    (``csrc/acl_walk.cuh``)."""
    fn = library(stem).hits_variant
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    v = fn(r, f)
    return v & 0xFF, (v >> 8) & 0xFF


def name_variant(data: torch.Tensor, dotted: torch.Tensor | None = None) -> tuple[int, int, bool, int]:
    """(lanes a row, 16-byte chunks a lane a step, 16-byte loads and
    stores, threads a block) that K8's launcher (``csrc/dns_name.cu``)
    takes for ``data`` [F, L] written to ``dotted`` (by default a buffer as
    the wrapper allocates it, 16-byte aligned)."""
    fn = library("dns_name").name_variant
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = 0 if dotted is None else dotted.data_ptr()
    v = fn(data.shape[1], data.shape[0], data.data_ptr(), out)
    return v & 0xFF, (v >> 8) & 0xFF, bool((v >> 16) & 1), v >> 17


def kafka_variant(r: int, f: int, t: int = 8) -> int:
    """Lanes a request that K17's launcher (``csrc/kafka_hits.cu``) takes
    for ``r`` rule rows, ``f`` requests and ``t`` topic slots."""
    fn = library("kafka_hits").kafka_variant
    fn.argtypes = [ctypes.c_int] * 3
    fn.restype = ctypes.c_int
    return fn(r, f, t)


def lpm_variant(w: int, n: int, groups: int) -> tuple[int, int]:
    """(lanes an address, mask groups a round) that K12's launcher
    (``csrc/lpm.cu``) takes for a table of ``n`` rows in ``groups`` mask
    groups at ``w`` words; groups 0 where it walks the rows instead."""
    fn = library("lpm").lpm_variant
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    v = fn(w, n, groups)
    return v >> 8, v & 0xFF


def cu_constants(stem: str) -> dict[str, int]:
    """The integer ``constexpr int kName = N;`` constants of ``csrc/<stem>.cu``
    by name.  A launcher's pick mirrored in Python reads its thresholds
    here, so the mirror and the launcher share one set of numbers."""
    text = (CSRC / f"{stem}.cu").read_text()
    return {m[1]: int(m[2]) for m in re.finditer(r"constexpr int (k\w+) = (\d+);", text)}


def seqdfa_apply_variant(f: int, r: int, s: int, k: int) -> tuple[int, int, int]:
    """(path, pairs a block, chunks a tile) that K18 apply's launcher
    (``csrc/seqdfa.cu``) takes for ``f`` x ``r`` pairs of ``k`` maps of
    ``s`` states: path 1 the walk, 2 staged; chunks 0 on the walk."""
    fn = library("seqdfa").seqdfa_apply_variant
    fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_int
    v = fn(f, r, s, k)
    return v & 7, (v >> 3) & 0xFF, v >> 11


def kafka_combine_variant(cover: torch.Tensor) -> int:
    """The path K22's launcher (``csrc/shard_reduce.cu``) takes for
    ``cover`` [R, F, T]: 1 a flow a thread, 2 the general path."""
    fn = library("shard_reduce").kafka_combine_variant
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn(p(cover), cover.shape[2])


def on_cpu(device: torch.device) -> bool:
    """True for the CPU (the plain version runs), False for a CUDA device
    (the kernel runs); raises for anything else."""
    if device.type == "cpu":
        return True
    if device.type == "cuda":
        return False
    raise ValueError(f"unsupported device {device}")


def p(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())

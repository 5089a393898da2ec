"""The sidecar's row build: a flat payload blob into the [F, W] batch rows.

Counterpart of the gather in ``cilium_tpu/sidecar/service.py:165``
(``_gather_model``, before its model call).  The service uploads only the
payload bytes of a chunk (one ``BLOB_CHUNK`` window) with each entry's
offset and length; the rows the batch models take are built on the
device:

    rows[i, c] = blob[clip(offs[i] + c, 0, B - 1)] if c < lens[i] else 0

On the card this is kernel K16 ``gather_rows`` (``csrc/gather_rows.cu``);
``gather_rows_plain`` is its plain PyTorch version, which the CPU runs.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels
from ..device import resolve_device

_GATHER_ROWS = kernels.CudaKernel(
    "gather_rows", "gather_rows",
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
)


def gather_rows_plain(blob: torch.Tensor, offs: torch.Tensor,
                      lens: torch.Tensor, width: int) -> torch.Tensor:
    """Plain PyTorch version of K16: [F, width] uint8."""
    col = torch.arange(width, dtype=torch.int64, device=blob.device)[None, :]
    g = (offs.long()[:, None] + col).clamp(0, blob.shape[0] - 1)
    return torch.where(
        col < lens.long()[:, None], blob[g], torch.zeros((), dtype=torch.uint8,
                                                         device=blob.device)
    )


def gather_rows(blob, offs, lens, width: int, device=None) -> torch.Tensor:
    """K16: the [F, width] uint8 rows of ``offs``/``lens`` (int32 [F]) into
    ``blob`` (uint8 [B], B >= 1).  Tensors must already lie on one device
    (numpy inputs are copied to ``device``, or to ``blob``'s device; with
    neither, to the card)."""
    if device is None and isinstance(blob, torch.Tensor):
        device = blob.device
    device = resolve_device(device)
    blob = kernels.arg(blob, "blob", torch.uint8, (None,), device)
    if blob.shape[0] < 1:
        raise ValueError("blob: expected at least one byte")
    offs = kernels.arg(offs, "offs", torch.int32, (None,), device)
    f = offs.shape[0]
    lens = kernels.arg(lens, "lens", torch.int32, (f,), device)
    width = int(width)
    if width < 0:
        raise ValueError(f"width: expected >= 0, got {width}")
    if kernels.on_cpu(device):
        return gather_rows_plain(blob, offs, lens, width)
    rows = torch.empty((f, width), dtype=torch.uint8, device=device)
    if f and width:
        p = kernels.p
        _GATHER_ROWS.launch(
            device, p(blob), blob.shape[0], p(offs), p(lens), f, width, p(rows),
        )
    return rows

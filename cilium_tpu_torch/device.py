"""Device choice for the port's entry points."""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card and raises when there is none; the CPU
    (the kernels' plain PyTorch versions) only when asked for by name."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "cilium_tpu_torch runs on a CUDA device and none is "
                "available; pass device='cpu' to run the plain PyTorch "
                "versions on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


def config_device(config):
    """The device a ``DaemonConfig`` names: ``"cpu"`` when its
    ``verdict_device`` is ``"cpu"``, else None (the card).  The daemon's
    endpoints, prefilter and engines all read it from here."""
    return "cpu" if getattr(config, "verdict_device", "default") == "cpu" else None


def as_tensor(x, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """A contiguous ``dtype`` tensor on ``device`` from a numpy array or a
    tensor (the models' ``__call__`` contract)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype).contiguous()
    # lint: disable=R9 -- host inputs only: a tensor (every captured call's input) returned above
    return torch.from_numpy(np.ascontiguousarray(x)).to(
        device=device, dtype=dtype
    ).contiguous()

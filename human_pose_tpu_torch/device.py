"""Device selection for the port's entry points, and constants kept on a
device."""

from __future__ import annotations

import functools

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """Return ``device`` as a ``torch.device``, refusing a CUDA device when
    no card is present (the port never drops to the CPU on its own: a caller
    that wants the CPU says ``device="cpu"``)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path"
        )
    return dev


@functools.lru_cache(maxsize=None)
def constant(values, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """``values`` (a number or a tuple) as a ``dtype`` tensor on ``device``,
    made once per (values, dtype, device) and shared by every caller, which
    must not write to it: a tensor made from host values on each call is a
    host->device copy from pageable memory, which waits for the stream."""
    return torch.tensor(values, dtype=dtype, device=device)

"""Explicit device resolution: a requested device is honoured or refused."""

from __future__ import annotations

import torch


def resolve_device(spec: str | torch.device) -> torch.device:
    """Turn "cpu", "cuda" or "cuda:N" into a torch.device.

    A CUDA request with no CUDA present raises; it never drops to the CPU.
    """
    dev = torch.device(spec)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(spec)!r} requested but CUDA is not available")
        index = 0 if dev.index is None else dev.index
        if index >= torch.cuda.device_count():
            raise RuntimeError(
                f"device {str(spec)!r} requested but only "
                f"{torch.cuda.device_count()} CUDA device(s) are visible")
        return torch.device("cuda", index)
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {str(spec)!r} (cpu or cuda[:N])")
    return dev

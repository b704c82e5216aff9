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


def parse_device(spec, default: str | torch.device = "cuda") -> torch.device:
    """A per-role device spec (config `tournament_device`, a worker's
    `--device`) as a torch.device (counterpart of
    keisei_tpu/parallel/placement.py:parse_device).

      None / "default"  the caller's device (`default`: the card unless the
                        caller passes its own)
      "cpu"             the host CPU
      "3", 3, "cuda:3"  card 3 ("cuda" alone: card 0)

    An unknown platform, no CUDA, or an index past the visible cards raises
    ValueError, so that a misconfigured job fails at startup, not mid-round.
    """
    if spec is None or spec == "default":
        spec = default
    if isinstance(spec, torch.device):
        spec = str(spec)
    if isinstance(spec, int):
        platform, index = "cuda", spec
    else:
        s = str(spec).strip().lower()
        platform, _, idx = s.partition(":")
        if platform.isdigit() and not idx:
            platform, idx = "cuda", platform
        if platform == "cpu":
            return torch.device("cpu")
        if platform != "cuda" or (idx and not idx.isdigit()):
            raise ValueError(f"device spec {spec!r}: unknown platform (cpu, cuda[:N] or N)")
        index = int(idx) if idx else 0
    if not torch.cuda.is_available():
        raise ValueError(f"device spec {spec!r}: CUDA is not available")
    if index >= torch.cuda.device_count():
        raise ValueError(f"device spec {spec!r}: index {index} out of range "
                         f"({torch.cuda.device_count()} CUDA device(s) visible)")
    return torch.device(platform, index)

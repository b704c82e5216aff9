"""Per-role device placement (counterpart of keisei_tpu/parallel/placement.py).

Learner ranks take cuda:0 .. cuda:L-1 of their host (one rank per card,
`learner_device`). A role that should not contend with them, such as
in-process tournament rounds (`[league] tournament_device`) or a sidecar
worker's `--device`, names a card outside them: cuda:L or higher.
`parse_device` is utils/device.py's.
"""

from __future__ import annotations

import torch

from ..utils.device import parse_device

__all__ = ["learner_device", "parse_device"]


def learner_device(platform: str, local_rank: int) -> torch.device:
    """The device of learner rank `local_rank` on its host: its own card,
    or the CPU for CPU ranks."""
    if platform == "cpu":
        return torch.device("cpu")
    return parse_device(f"cuda:{local_rank}")

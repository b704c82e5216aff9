"""Model output contract (counterpart of keisei_tpu/models/base.py).

Models take observations as (B, C, 9, 9) float32 (the env's layout).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

SPATIAL_MOVE_TYPES = 139


@dataclass
class KataGoOutput:
    policy_logits: torch.Tensor  # (B, 9, 9, 139) f32
    value_logits: torch.Tensor   # (B, 3) f32, W/D/L
    score_lead: torch.Tensor     # (B, 1) f32

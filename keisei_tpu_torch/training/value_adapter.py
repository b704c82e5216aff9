"""Value-head adapter for the KataGo contract (counterpart of
keisei_tpu/training/value_adapter.py): W/D/L cross-entropy + score MSE,
scalar value = P(W) - P(L), optional score blending into the GAE value.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..models.base import KataGoOutput


@dataclass(frozen=True)
class MultiHeadValueAdapter:
    lambda_value: float = 1.5
    lambda_score: float = 0.02
    score_blend_alpha: float = 0.0

    def scalar_value(self, out: KataGoOutput) -> torch.Tensor:
        probs = torch.softmax(out.value_logits.float(), dim=-1)
        return probs[:, 0] - probs[:, 2]

    def scalar_value_blended(self, out: KataGoOutput) -> torch.Tensor:
        v = self.scalar_value(out)
        if self.score_blend_alpha > 0.0:
            s = torch.tanh(out.score_lead[:, 0].float())
            v = (1.0 - self.score_blend_alpha) * v + self.score_blend_alpha * s
        return v

    def value_loss(self, out: KataGoOutput, *, returns, value_cats, score_targets):
        """(weighted value + score loss, raw score loss); self-play weights
        every sample 1, so the league-only sample weights are not ported."""
        del returns
        logits = out.value_logits.float()
        logp = F.log_softmax(logits, dim=-1)
        valid = value_cats >= 0
        cats = torch.clamp(value_cats, min=0).long()
        ce = -torch.gather(logp, 1, cats[:, None])[:, 0]
        n_valid = valid.sum()
        wdl = torch.where(valid, ce, 0.0).sum() / torch.clamp(n_valid, min=1)
        # graph-connected zero when no labels
        wdl = torch.where(n_valid > 0, wdl, logits.sum() * 0.0)
        score = ((out.score_lead[:, 0].float() - score_targets) ** 2).mean()
        return self.lambda_value * wdl + self.lambda_score * score, score


def get_value_adapter(contract: str, **kwargs) -> MultiHeadValueAdapter:
    if contract == "katago":
        return MultiHeadValueAdapter(**kwargs)
    if contract == "scalar":
        raise NotImplementedError("the scalar value adapter is not yet ported")
    raise ValueError(f"unknown model contract {contract!r}")

"""Fused inference forward for the SE-ResNet (counterpart of
keisei_tpu/models/fused_infer.py:make_fused_forward), eval mode.

The trunk runs in the (9, 9, B, C) spatial-major layout: the input conv is
`ops.conv3x3.conv3x3_hwbc`, each block one `ops.fused_block.
fused_gpbias_block` launch. The heads (<0.3% of the FLOPs) are plain torch
in the same layout, as they run outside any Pallas kernel in JAX.

`FusedForward.prepare(model)` folds the BatchNorm affines (s = scale /
sqrt(var + eps), b = bias - mean * s, eps 1e-5) and lays out the bf16
weights once per set of weights; the rollout calls it once per epoch and
reuses the result for every ply (the JAX side gets the same effect from
XLA hoisting the fold out of the rollout scan).

The int8 path (`make_quantized_forward`) is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops.conv3x3 import conv3x3_hwbc
from ..ops.fused_block import fused_gpbias_block
from .base import KataGoOutput
from .se_resnet import BN_EPS, FlaxBatchNorm, SEResNetModel, SEResNetParams, global_pool


def _bn_affine(bn: FlaxBatchNorm) -> tuple[torch.Tensor, torch.Tensor]:
    s = bn.weight / torch.sqrt(bn.running_var + BN_EPS)
    return s, bn.bias - bn.running_mean * s


def _conv_hwio(conv: torch.nn.Conv2d) -> torch.Tensor:
    """OIHW -> (3, 3, Cin, Cout) bf16, contiguous."""
    return conv.weight.permute(2, 3, 1, 0).contiguous().to(torch.bfloat16)


def _dense(lin: torch.nn.Linear, dtype=torch.bfloat16) -> tuple[torch.Tensor, torch.Tensor]:
    """(in, out) kernel in `dtype` and f32 bias."""
    return lin.weight.t().contiguous().to(dtype), lin.bias.float().contiguous()


@dataclass
class FusedWeights:
    """Weights folded and laid out for the fused forward."""

    input_w: torch.Tensor
    input_s: torch.Tensor
    input_b: torch.Tensor
    blocks: list[tuple[torch.Tensor, ...]]
    heads: dict[str, torch.Tensor]


class FusedForward:
    """fwd(weights, obs (B, C, 9, 9) f32) -> KataGoOutput, eval mode."""

    def __init__(self, cfg: SEResNetParams):
        self.cfg = cfg

    @torch.no_grad()
    def prepare(self, model: SEResNetModel) -> FusedWeights:
        s, b = _bn_affine(model.input_bn)
        blocks = []
        for blk in model.blocks():
            s1, b1 = _bn_affine(blk.bn1)
            s2, b2 = _bn_affine(blk.bn2)
            blocks.append((
                _conv_hwio(blk.conv1), _conv_hwio(blk.conv2),
                torch.stack([s1, b1, s2, b2]).float().contiguous(),
                *_dense(blk.gp_fc1), *_dense(blk.gp_fc2),
                *_dense(blk.se_fc1), *_dense(blk.se_fc2),
            ))
        ps, pb = _bn_affine(model.policy_bn1)
        heads = {
            "policy_w1": model.policy_conv1.weight[:, :, 0, 0].t().contiguous().to(torch.bfloat16),
            "policy_s": ps, "policy_b": pb,
            "policy_w2": model.policy_conv2.weight[:, :, 0, 0].t().contiguous().to(torch.bfloat16),
            "policy_b2": model.policy_conv2.bias.float(),
        }
        for name, dtype in (("value_fc1", torch.bfloat16), ("value_fc2", torch.float32),
                            ("score_fc1", torch.bfloat16), ("score_fc2", torch.float32)):
            heads[name + "_w"], heads[name + "_b"] = _dense(getattr(model, name), dtype)
        return FusedWeights(_conv_hwio(model.input_conv), s, b, blocks, heads)

    @torch.no_grad()
    def __call__(self, w: FusedWeights, obs: torch.Tensor) -> KataGoOutput:
        cfg = self.cfg
        if obs.dim() != 4 or obs.shape[1] != cfg.obs_channels or tuple(obs.shape[2:]) != (9, 9):
            raise ValueError(f"expected obs (B, {cfg.obs_channels}, 9, 9), got {tuple(obs.shape)}")
        x = obs.permute(2, 3, 0, 1).to(torch.bfloat16).contiguous()     # (9, 9, B, Cin)
        x = conv3x3_hwbc(x, w.input_w)
        x = torch.relu(x.float() * w.input_s + w.input_b).to(torch.bfloat16)
        for blk in w.blocks:
            x = fused_gpbias_block(x, *blk)
        return _apply_heads(w.heads, x)


def _apply_heads(h: dict[str, torch.Tensor], x: torch.Tensor) -> KataGoOutput:
    """Policy/value/score heads on a (9, 9, B, C) bf16 trunk output."""
    bf16, f32 = torch.bfloat16, torch.float32
    pol = (x @ h["policy_w1"]).float() * h["policy_s"] + h["policy_b"]
    pol = torch.relu(pol).to(bf16) @ h["policy_w2"]
    policy = (pol.float() + h["policy_b2"]).permute(2, 0, 1, 3)        # (B, 9, 9, 139)

    pool = global_pool(x.permute(2, 3, 0, 1)).to(bf16)

    def dense(z, name, dtype):
        return z.to(dtype) @ h[name + "_w"] + h[name + "_b"].to(dtype)

    v = torch.relu(dense(pool, "value_fc1", bf16))
    value = dense(v, "value_fc2", f32)
    sc = torch.relu(dense(pool, "score_fc1", bf16))
    score = dense(sc, "score_fc2", f32)
    return KataGoOutput(policy_logits=policy.contiguous(), value_logits=value, score_lead=score)


def make_fused_forward(cfg: SEResNetParams) -> FusedForward:
    return FusedForward(cfg)

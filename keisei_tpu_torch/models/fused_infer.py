"""Fused inference forward for the SE-ResNet (counterpart of
keisei_tpu/models/fused_infer.py:make_fused_forward), eval mode.

The trunk runs in the (9, 9, B, C) spatial-major layout: the input conv is
`ops.conv3x3.conv3x3_hwbc` on observation planes padded with zero channels
to a multiple of 64 (the wgmma kernel's K chunk; the pad is written where
the observation is cast to bf16, and `prepare` pads the weights once), each
block one `ops.fused_block.fused_gpbias_block` call (four kernels on the
card). The heads (<0.3% of the FLOPs) are plain torch in the same layout,
as they run outside any Pallas kernel in JAX.

`FusedForward.prepare(model)` folds the BatchNorm affines (s = scale /
sqrt(var + eps), b = bias - mean * s, eps 1e-5) and lays out the bf16
weights once per set of weights; the rollout calls it once per epoch and
reuses the result for every ply (the JAX side gets the same effect from
XLA hoisting the fold out of the rollout scan).

`QuantizedForward` (counterpart of make_quantized_forward) runs the same
input conv and heads around an int8 trunk: the f32 trunk input is quantized
per tile of boards (`ops.qblock.pack_quantized`), each block is one
`ops.qblock.quantized_gpbias_block` call, and the last block's int8 output
is dequantized and cast to bf16 for the heads. `prepare` quantizes the conv
weights once per set of weights and folds their scales into the BatchNorm
rows as [s1 * ws1, b1, s2 * ws2, b2].
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops.conv3x3 import conv3x3_hwbc, pad_channels
from ..ops.fused_block import fused_gpbias_block
from ..ops.qblock import (int8_batch_tile, pack_quantized, quantize_conv_weights,
                          quantized_gpbias_block, unpack_dequantized)
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


def _block_fcs(blk) -> tuple[torch.Tensor, ...]:
    """The block's four in-block FCs (gp_fc1, gp_fc2, se_fc1, se_fc2), each
    as a bf16 kernel and an f32 bias, as both block kernels take them."""
    return (*_dense(blk.gp_fc1), *_dense(blk.gp_fc2), *_dense(blk.se_fc1), *_dense(blk.se_fc2))


def padded_planes(obs: torch.Tensor, channels: int) -> torch.Tensor:
    """obs (B, Cin, 9, 9) -> (9, 9, B, channels) bf16, contiguous: the planes
    in the trunk's layout with zero channels from Cin up (a zero fill and one
    strided cast copy, where unpadded planes take the cast copy alone)."""
    x = obs.new_zeros((9, 9, obs.shape[0], channels), dtype=torch.bfloat16)
    x[..., :obs.shape[1]] = obs.permute(2, 3, 0, 1)
    return x


@dataclass
class FusedWeights:
    """Weights folded and laid out for the fused forward."""

    input_w: torch.Tensor   # (3, 3, Cin padded to a multiple of 64, C), the pad exact zeros
    input_s: torch.Tensor
    input_b: torch.Tensor
    blocks: list[tuple[torch.Tensor, ...]]
    heads: dict[str, torch.Tensor]


class FusedForward:
    """fwd(weights, obs (B, C, 9, 9) f32) -> KataGoOutput, eval mode."""

    def __init__(self, cfg: SEResNetParams):
        self.cfg = cfg

    @staticmethod
    def _block_weights(blk) -> tuple[torch.Tensor, ...]:
        s1, b1 = _bn_affine(blk.bn1)
        s2, b2 = _bn_affine(blk.bn2)
        return (_conv_hwio(blk.conv1), _conv_hwio(blk.conv2),
                torch.stack([s1, b1, s2, b2]).float().contiguous(), *_block_fcs(blk))

    @torch.no_grad()
    def prepare(self, model: SEResNetModel) -> FusedWeights:
        s, b = _bn_affine(model.input_bn)
        blocks = [self._block_weights(blk) for blk in model.blocks()]
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
        return FusedWeights(pad_channels(_conv_hwio(model.input_conv), 2), s, b, blocks, heads)

    def _trunk_input(self, w: FusedWeights, obs: torch.Tensor) -> torch.Tensor:
        """Validate obs; the input conv, folded input BN and relu ->
        (9, 9, B, C) f32, shared by the bf16 and the int8 trunk."""
        cfg = self.cfg
        if obs.dim() != 4 or obs.shape[1] != cfg.obs_channels or tuple(obs.shape[2:]) != (9, 9):
            raise ValueError(f"expected obs (B, {cfg.obs_channels}, 9, 9), got {tuple(obs.shape)}")
        x = conv3x3_hwbc(padded_planes(obs, w.input_w.shape[2]), w.input_w)
        return torch.relu(x.float() * w.input_s + w.input_b)

    @torch.no_grad()
    def __call__(self, w: FusedWeights, obs: torch.Tensor) -> KataGoOutput:
        x = self._trunk_input(w, obs).to(torch.bfloat16)
        for blk in w.blocks:
            x = fused_gpbias_block(x, *blk)
        return _apply_heads(w.heads, x)


class QuantizedForward(FusedForward):
    """fwd(weights, obs (B, C, 9, 9) f32) -> KataGoOutput with an int8
    trunk, eval mode. B must be divisible by 32, the quantization tile
    (`ops.qblock.int8_batch_tile`).

    `block_fn` is the block it calls; chip_smoke.py sets it to the plain
    version on one instance to hold the kernel path to it on the card."""

    block_fn = staticmethod(quantized_gpbias_block)

    @staticmethod
    def _block_weights(blk) -> tuple[torch.Tensor, ...]:
        s1, b1 = _bn_affine(blk.bn1)
        s2, b2 = _bn_affine(blk.bn2)
        wq1, ws1 = quantize_conv_weights(blk.conv1.weight.permute(2, 3, 1, 0))
        wq2, ws2 = quantize_conv_weights(blk.conv2.weight.permute(2, 3, 1, 0))
        return (wq1, wq2, torch.stack([s1 * ws1, b1, s2 * ws2, b2]).float().contiguous(),
                *_block_fcs(blk))

    @torch.no_grad()
    def __call__(self, w: FusedWeights, obs: torch.Tensor) -> KataGoOutput:
        bt = int8_batch_tile(obs.shape[0])
        xq, sx = pack_quantized(self._trunk_input(w, obs), bt)
        for blk in w.blocks:
            xq, sx = self.block_fn(xq, sx, *blk, batch_tile=bt)
        return _apply_heads(w.heads, unpack_dequantized(xq, sx, bt).to(torch.bfloat16))


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


def make_quantized_forward(cfg: SEResNetParams) -> QuantizedForward:
    return QuantizedForward(cfg)

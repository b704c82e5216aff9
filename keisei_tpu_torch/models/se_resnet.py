"""SE-ResNet with KataGo-style global-pooling bias (counterpart of
keisei_tpu/models/se_resnet.py), as eager nn.Modules for training and the
plain eval forward.

Per block: conv-BN-ReLU, plus a broadcast bias from FC(mean||max||std of
the block INPUT), conv-BN, SE scale+shift, residual, ReLU. Heads: policy
1x1 convs -> (B, 9, 9, 139); shared global pool -> W/D/L value and score.

Numerics follow the flax model where PyTorch's defaults differ:
- `FlaxBatchNorm` takes batch statistics as flax does (float32,
  var = E[x^2] - E[x]^2 clipped at 0, i.e. biased) and moves the running
  statistics by `0.9 * old + 0.1 * batch` (flax momentum 0.9, eps 1e-5);
- the global pool's std is the population std with 1e-10 inside the sqrt;
- compute runs in `params.dtype` (bfloat16 by default, via autocast),
  parameters and BatchNorm statistics stay float32, and value_fc2 /
  score_fc2 run in float32 as the flax model's do.
Layout is NCHW inside; the policy logits leave as (B, 9, 9, 139).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn as nn
import torch.nn.functional as F

from .base import SPATIAL_MOVE_TYPES, KataGoOutput

BN_MOMENTUM = 0.9  # flax convention: running = momentum * running + (1 - momentum) * batch
BN_EPS = 1e-5

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclass(frozen=True)
class SEResNetParams:
    num_blocks: int = 40
    channels: int = 256
    se_reduction: int = 16
    global_pool_channels: int = 128
    policy_channels: int = 32
    value_fc_size: int = 256
    score_fc_size: int = 128
    obs_channels: int = 50
    dtype: torch.dtype = torch.bfloat16

    def __post_init__(self):
        for f in ("num_blocks", "channels", "se_reduction", "global_pool_channels",
                  "policy_channels", "value_fc_size", "score_fc_size", "obs_channels"):
            if getattr(self, f) < 1:
                raise ValueError(f"{f} must be >= 1, got {getattr(self, f)}")
        if self.channels // self.se_reduction < 1:
            raise ValueError("channels // se_reduction must be >= 1")
        if isinstance(self.dtype, str):
            if self.dtype not in _DTYPES:
                raise ValueError(f"dtype must be one of {sorted(_DTYPES)}, got {self.dtype!r}")
            object.__setattr__(self, "dtype", _DTYPES[self.dtype])
        if self.dtype not in _DTYPES.values():
            raise ValueError(f"dtype must be bfloat16 or float32, got {self.dtype}")


class FlaxBatchNorm(nn.Module):
    """BatchNorm over (N, H, W) of an NCHW tensor with flax's statistics."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if self.training:
            mean = xf.mean(dim=(0, 2, 3))
            mean2 = (xf * xf).mean(dim=(0, 2, 3))
            var = torch.clamp(mean2 - mean * mean, min=0.0)
            with torch.no_grad():
                self.running_mean.mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * mean)
                self.running_var.mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + BN_EPS) * self.weight
        y = (xf - mean[None, :, None, None]) * mul[None, :, None, None] + self.bias[None, :, None, None]
        return y.to(x.dtype)


def global_pool(x: torch.Tensor) -> torch.Tensor:
    """mean || max || population-std over H, W of an NCHW tensor: (B, 3C) f32."""
    xf = x.float()
    mean = xf.mean(dim=(2, 3))
    amax = xf.amax(dim=(2, 3))
    var = ((xf - mean[:, :, None, None]) ** 2).mean(dim=(2, 3))
    return torch.cat([mean, amax, torch.sqrt(var + 1e-10)], dim=1)


def _conv3(cin: int, cout: int) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, 3, padding=1, bias=False)


class GlobalPoolBiasBlock(nn.Module):
    def __init__(self, channels: int, se_reduction: int, global_pool_channels: int):
        super().__init__()
        ch = channels
        self.conv1 = _conv3(ch, ch)
        self.bn1 = FlaxBatchNorm(ch)
        self.gp_fc1 = nn.Linear(3 * ch, global_pool_channels)
        self.gp_fc2 = nn.Linear(global_pool_channels, ch)
        self.conv2 = _conv3(ch, ch)
        self.bn2 = FlaxBatchNorm(ch)
        self.se_fc1 = nn.Linear(ch, ch // se_reduction)
        self.se_fc2 = nn.Linear(ch // se_reduction, 2 * ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        g = self.gp_fc2(F.relu(self.gp_fc1(global_pool(x))))
        out = out + g[:, :, None, None].to(out.dtype)
        out = self.bn2(self.conv2(out))
        se = self.se_fc2(F.relu(self.se_fc1(out.float().mean(dim=(2, 3)))))
        scale, shift = se.chunk(2, dim=1)
        out = out * torch.sigmoid(scale)[:, :, None, None] + shift[:, :, None, None]
        return F.relu(out + x)


class SEResNetModel(nn.Module):
    """Eager SE-ResNet. Submodule names follow the flax parameter tree
    (input_conv, block{i}.conv1, ...), so models/convert.py maps 1:1."""

    def __init__(self, params_cfg: SEResNetParams):
        super().__init__()
        p = self.params_cfg = params_cfg
        self.input_conv = _conv3(p.obs_channels, p.channels)
        self.input_bn = FlaxBatchNorm(p.channels)
        for i in range(p.num_blocks):
            self.add_module(f"block{i}", GlobalPoolBiasBlock(
                p.channels, p.se_reduction, p.global_pool_channels))
        self.policy_conv1 = nn.Conv2d(p.channels, p.policy_channels, 1, bias=False)
        self.policy_bn1 = FlaxBatchNorm(p.policy_channels)
        self.policy_conv2 = nn.Conv2d(p.policy_channels, SPATIAL_MOVE_TYPES, 1)
        self.value_fc1 = nn.Linear(3 * p.channels, p.value_fc_size)
        self.value_fc2 = nn.Linear(p.value_fc_size, 3)
        self.score_fc1 = nn.Linear(3 * p.channels, p.score_fc_size)
        self.score_fc2 = nn.Linear(p.score_fc_size, 1)

    def blocks(self):
        return [getattr(self, f"block{i}") for i in range(self.params_cfg.num_blocks)]

    def forward(self, obs: torch.Tensor) -> KataGoOutput:
        p = self.params_cfg
        if obs.dim() != 4 or obs.shape[1] != p.obs_channels or tuple(obs.shape[2:]) != (9, 9):
            raise ValueError(f"expected obs (B, {p.obs_channels}, 9, 9), got {tuple(obs.shape)}")
        low = p.dtype != torch.float32
        with torch.autocast(device_type=obs.device.type, dtype=p.dtype, enabled=low):
            x = F.relu(self.input_bn(self.input_conv(obs.float())))
            for blk in self.blocks():
                x = blk(x)
            pol = F.relu(self.policy_bn1(self.policy_conv1(x)))
            pol = self.policy_conv2(pol)
            pool = global_pool(x)
            v = F.relu(self.value_fc1(pool))
            s = F.relu(self.score_fc1(pool))
        value = self.value_fc2(v.float())
        score = self.score_fc2(s.float())
        return KataGoOutput(
            policy_logits=pol.float().permute(0, 2, 3, 1),
            value_logits=value,
            score_lead=score,
        )

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
  under `synced_batch_stats` (the data-parallel update) E[x] and E[x^2]
  are those of the global batch, summed over the ranks, as XLA makes them
  global under the JAX package's mesh;
- the global pool's std is the population std with 1e-10 inside the sqrt;
- compute runs in `params.dtype` (bfloat16 by default, via autocast),
  parameters and BatchNorm statistics stay float32, and value_fc2 /
  score_fc2 run in float32 as the flax model's do. A bfloat16 state dict
  (a league snapshot, through `torch.func.functional_call`) runs the same
  way: BatchNorm and the two float32 heads widen its tensors first.
Layout is NCHW inside; the policy logits leave as (B, 9, 9, 139).
"""

from __future__ import annotations

import contextlib
from collections.abc import Callable
from dataclasses import dataclass

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

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
        # False while a checkpointed block is recomputed in the backward:
        # the step's forward has moved the statistics already
        self.update_statistics = True
        # (reduce, share) inside synced_batch_stats: the batch is this
        # rank's `share` of a global batch, and `reduce` sums over the ranks
        self.sync: tuple[Callable[[torch.Tensor], torch.Tensor], float] | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        if self.training:
            mean = xf.mean(dim=(0, 2, 3))
            mean2 = (xf * xf).mean(dim=(0, 2, 3))
            if self.sync is not None:
                # the global E[x], E[x^2]: each rank's means weighted by its
                # share of the rows, summed (differentiably) over the ranks;
                # one rank (share 1.0) keeps the local values bit for bit
                reduce, share = self.sync
                mean, mean2 = reduce(torch.cat([mean, mean2]) * share).chunk(2)
            var = torch.clamp(mean2 - mean * mean, min=0.0)
            if self.update_statistics:
                with torch.no_grad():
                    self.running_mean.mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * mean)
                    self.running_var.mul_(BN_MOMENTUM).add_((1 - BN_MOMENTUM) * var)
        else:
            mean, var = self.running_mean.float(), self.running_var.float()
        mul = torch.rsqrt(var + BN_EPS) * self.weight.float()
        y = ((xf - mean[None, :, None, None]) * mul[None, :, None, None]
             + self.bias.float()[None, :, None, None])
        return y.to(x.dtype)


def global_pool(x: torch.Tensor) -> torch.Tensor:
    """mean || max || population-std over H, W of an NCHW tensor: (B, 3C) f32."""
    xf = x.float()
    mean = xf.mean(dim=(2, 3))
    amax = xf.amax(dim=(2, 3))
    var = ((xf - mean[:, :, None, None]) ** 2).mean(dim=(2, 3))
    return torch.cat([mean, amax, torch.sqrt(var + 1e-10)], dim=1)


def _linear_f32(fc: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """`fc` in float32 whatever its weights' type: a bfloat16 snapshot's
    weights are widened, as flax widens them for a float32 Dense."""
    return F.linear(x.float(), fc.weight.float(), fc.bias.float())


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


@contextlib.contextmanager
def _statistics_frozen(module: nn.Module):
    """`module`'s BatchNorm layers normalise with batch statistics but do
    not move their running statistics."""
    bns = [m for m in module.modules() if isinstance(m, FlaxBatchNorm)]
    for bn in bns:
        bn.update_statistics = False
    try:
        yield
    finally:
        for bn in bns:
            bn.update_statistics = True


@contextlib.contextmanager
def synced_batch_stats(module: nn.Module,
                       reduce: Callable[[torch.Tensor], torch.Tensor], share: float):
    """`module`'s BatchNorm layers take the statistics of the global batch
    in train mode: this rank holds `share` (its rows over the global rows)
    of it, the other ranks the rest, and `reduce` sums a tensor over the
    ranks, differentiably (parallel.mesh.all_reduce_sum). Every rank enters
    the same forwards and backwards (one reduce per layer in each), so the
    running statistics move identically on every rank."""
    bns = [m for m in module.modules() if isinstance(m, FlaxBatchNorm)]
    for bn in bns:
        bn.sync = (reduce, share)
    try:
        yield
    finally:
        for bn in bns:
            bn.sync = None


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

    def forward(self, obs: torch.Tensor, recompute_blocks: bool = False) -> KataGoOutput:
        """`recompute_blocks`: keep only each block's input for the
        backward and recompute the block there (non-reentrant
        torch.utils.checkpoint), with the same values and gradients; the
        recompute leaves the BatchNorm statistics as the forward moved them."""
        p = self.params_cfg
        if obs.dim() != 4 or obs.shape[1] != p.obs_channels or tuple(obs.shape[2:]) != (9, 9):
            raise ValueError(f"expected obs (B, {p.obs_channels}, 9, 9), got {tuple(obs.shape)}")
        low = p.dtype != torch.float32
        with torch.autocast(device_type=obs.device.type, dtype=p.dtype, enabled=low):
            x = F.relu(self.input_bn(self.input_conv(obs.float())))
            for blk in self.blocks():
                if recompute_blocks:
                    x = checkpoint(blk, x, use_reentrant=False,
                                   context_fn=lambda b=blk: (contextlib.nullcontext(),
                                                             _statistics_frozen(b)))
                else:
                    x = blk(x)
            pol = F.relu(self.policy_bn1(self.policy_conv1(x)))
            pol = self.policy_conv2(pol)
            pool = global_pool(x)
            v = F.relu(self.value_fc1(pool))
            s = F.relu(self.score_fc1(pool))
        value = _linear_f32(self.value_fc2, v)
        score = _linear_f32(self.score_fc2, s)
        return KataGoOutput(
            policy_logits=pol.float().permute(0, 2, 3, 1),
            value_logits=value,
            score_lead=score,
        )


# -- G weight sets in one forward ---------------------------------------------------
#
# The concurrent match pool plays 2P pairings' sides at once. torch.func.vmap
# of functional_call over the stacked state dicts is refused here: under vmap
# the autocast region of SEResNetModel.forward does not cast (a conv then
# meets f32 boards and bf16 weights). So the stacked forward is written out:
# activations in an (E, G*C, 9, 9) layout, every conv one grouped conv
# (groups = G) over the G weight sets, every Dense one batched matmul, and
# each op in the dtype autocast gives it in the eager forward (convs and
# Dense in `params.dtype`, BatchNorm and the pool's statistics in f32).


def _gconv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None, pad: int) -> torch.Tensor:
    """Grouped conv of (E, G*Cin, 9, 9) by G stacked (Cout, Cin, k, k) kernels."""
    G = w.shape[0]
    return F.conv2d(x, w.reshape(-1, *w.shape[2:]).to(x.dtype),
                    None if b is None else b.reshape(-1).to(x.dtype), padding=pad, groups=G)


def _gbn(x: torch.Tensor, sd: dict, name: str) -> torch.Tensor:
    """FlaxBatchNorm's eval path over G stacked statistics."""
    xf = x.float()
    mean = sd[f"{name}.running_mean"].float().reshape(-1)
    var = sd[f"{name}.running_var"].float().reshape(-1)
    mul = torch.rsqrt(var + BN_EPS) * sd[f"{name}.weight"].float().reshape(-1)
    y = ((xf - mean[None, :, None, None]) * mul[None, :, None, None]
         + sd[f"{name}.bias"].float().reshape(-1)[None, :, None, None])
    return y.to(x.dtype)


def _gdense(x: torch.Tensor, sd: dict, name: str, dtype: torch.dtype) -> torch.Tensor:
    """(E, G, in) through G stacked Linear layers -> (E, G, out) in `dtype`."""
    w, b = sd[f"{name}.weight"].to(dtype), sd[f"{name}.bias"].to(dtype)
    y = torch.baddbmm(b[:, None, :], x.to(dtype).transpose(0, 1), w.transpose(1, 2))
    return y.transpose(0, 1)


def _gpool(x: torch.Tensor, G: int) -> torch.Tensor:
    """global_pool per weight set: (E, G*C, 9, 9) -> (E, G, 3C) f32."""
    E = x.shape[0]
    xf = x.float().reshape(E, G, -1, 81)
    mean = xf.mean(dim=-1)
    amax = xf.amax(dim=-1)
    var = ((xf - mean[..., None]) ** 2).mean(dim=-1)
    return torch.cat([mean, amax, torch.sqrt(var + 1e-10)], dim=-1)


def stacked_policy_logits(cfg: SEResNetParams, sd: dict, obs: torch.Tensor) -> torch.Tensor:
    """Policy logits of G weight sets at once.

    sd: a state dict of SEResNetModel with every tensor stacked on a
    leading G (any float dtype); obs: (G, E, obs_channels, 81) boards, set g
    for weight set g. Returns (G, E, 9*9*139) f32 logits, each set's as
    `SEResNetModel(...)(obs[g]).policy_logits.reshape(E, -1)` computes them
    (to the rounding of the compute dtype)."""
    G, E = obs.shape[:2]
    dt = cfg.dtype
    x = obs.transpose(0, 1).reshape(E, G * cfg.obs_channels, 9, 9).to(dt)
    x = F.relu(_gbn(_gconv(x, sd["input_conv.weight"], None, 1), sd, "input_bn"))
    for i in range(cfg.num_blocks):
        p = f"block{i}"
        out = F.relu(_gbn(_gconv(x, sd[f"{p}.conv1.weight"], None, 1), sd, f"{p}.bn1"))
        g = _gdense(F.relu(_gdense(_gpool(x, G), sd, f"{p}.gp_fc1", dt)), sd, f"{p}.gp_fc2", dt)
        out = out + g.reshape(E, -1)[:, :, None, None].to(out.dtype)
        out = _gbn(_gconv(out, sd[f"{p}.conv2.weight"], None, 1), sd, f"{p}.bn2")
        mean = out.float().mean(dim=(2, 3)).reshape(E, G, -1)
        se = _gdense(F.relu(_gdense(mean, sd, f"{p}.se_fc1", dt)), sd, f"{p}.se_fc2", dt)
        scale, shift = se.chunk(2, dim=-1)
        out = (out * torch.sigmoid(scale).reshape(E, -1)[:, :, None, None]
               + shift.reshape(E, -1)[:, :, None, None])
        x = F.relu(out + x)
    pol = F.relu(_gbn(_gconv(x, sd["policy_conv1.weight"], None, 0), sd, "policy_bn1"))
    pol = _gconv(pol, sd["policy_conv2.weight"], sd["policy_conv2.bias"], 0)
    pol = pol.float().reshape(E, G, SPATIAL_MOVE_TYPES, 9, 9).permute(1, 0, 3, 4, 2)
    return pol.reshape(G, E, -1)

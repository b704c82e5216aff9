"""The plain float32 reference of the KataGo-style SE-ResNet (architecture
`se_resnet`): its weights from the seed, its eval and train forward, and
its operations and bytes, written from the model's equations. The contract
it keeps is arch/__init__.py's.

Weights: `init_state(widths, seed, device)` draws every weight from the seed
in one call of a device generator (PyTorch's default bounds, U(-1/sqrt(fan_in),
1/sqrt(fan_in))), with BatchNorm scale 1, shift 0 and statistics (0, 1). The
keys are the program's state-dict names.

Model (per block): conv-BN-ReLU plus a bias from FC(mean || max || std of the
block input), conv-BN, SE scale and shift, residual, ReLU. Heads: policy
1x1 conv-BN-ReLU, 1x1 conv with bias -> (B, 9, 9, 139); the trunk's global
pool -> W/D/L logits and the score lead. BatchNorm in train mode takes the
batch's mean and biased variance (E[x^2] - E[x]^2, clipped at 0), eps 1e-5;
the pool's std is the population std with 1e-10 inside the sqrt. `quant`
(the control's float8) goes through the inputs and weights of every
convolution and bf16 Dense layer.

Train-mode BatchNorm mixes a minibatch's rows, so the reference's step takes
a whole minibatch at once (`TRAIN_ROWS_PER_BLOCK = None`). The rollout's
control is the program's own int8 forward (`ROLLOUT_CONTROL`), one precision
below its fused bf16 one.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from bench_torch.flops import SQUARES, bound_s
from bench_torch.reference import SPATIAL_MOVE_TYPES

BN_EPS = 1e-5
TRAIN_ROWS_PER_BLOCK = None
ROLLOUT_CONTROL = "int8"


@dataclass(frozen=True)
class Widths:
    num_blocks: int
    channels: int
    se_reduction: int
    global_pool_channels: int
    policy_channels: int
    value_fc_size: int
    score_fc_size: int
    obs_channels: int

    @classmethod
    def from_params(cls, params: dict) -> "Widths":
        return cls(**{k: int(params[k]) for k in cls.__dataclass_fields__})


# -- weights ---------------------------------------------------------------------------

def weight_shapes(w: Widths) -> dict[str, tuple[tuple[int, ...], int]]:
    """name -> (shape, fan_in) of every randomly drawn tensor, in draw order."""
    C, gpc, sec = w.channels, w.global_pool_channels, w.channels // w.se_reduction
    out: dict[str, tuple[tuple[int, ...], int]] = {}

    def conv(name, cout, cin, k):
        out[f"{name}.weight"] = ((cout, cin, k, k), cin * k * k)

    def dense(name, fout, fin):
        out[f"{name}.weight"] = ((fout, fin), fin)
        out[f"{name}.bias"] = ((fout,), fin)

    conv("input_conv", C, w.obs_channels, 3)
    for i in range(w.num_blocks):
        p = f"block{i}"
        conv(f"{p}.conv1", C, C, 3)
        dense(f"{p}.gp_fc1", gpc, 3 * C)
        dense(f"{p}.gp_fc2", C, gpc)
        conv(f"{p}.conv2", C, C, 3)
        dense(f"{p}.se_fc1", sec, C)
        dense(f"{p}.se_fc2", 2 * C, sec)
    conv("policy_conv1", w.policy_channels, C, 1)
    conv("policy_conv2", SPATIAL_MOVE_TYPES, w.policy_channels, 1)
    out["policy_conv2.bias"] = ((SPATIAL_MOVE_TYPES,), w.policy_channels)
    dense("value_fc1", w.value_fc_size, 3 * C)
    dense("value_fc2", 3, w.value_fc_size)
    dense("score_fc1", w.score_fc_size, 3 * C)
    dense("score_fc2", 1, w.score_fc_size)
    return out


def batchnorm_names(w: Widths) -> dict[str, int]:
    """BatchNorm layer -> channels."""
    bns = {"input_bn": w.channels}
    for i in range(w.num_blocks):
        bns[f"block{i}.bn1"] = w.channels
        bns[f"block{i}.bn2"] = w.channels
    bns["policy_bn1"] = w.policy_channels
    return bns


def init_state(w: Widths, seed: int, device) -> dict[str, torch.Tensor]:
    """The full state (parameters and BatchNorm statistics) from `seed`:
    one uniform draw on `device` for every random tensor."""
    shapes = weight_shapes(w)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    total = sum(math.prod(s) for s, _ in shapes.values())
    u = torch.rand(total, generator=g, device=device).mul_(2.0).sub_(1.0)
    state, at = {}, 0
    for name, (shape, fan_in) in shapes.items():
        n = math.prod(shape)
        state[name] = (u[at:at + n] / math.sqrt(fan_in)).reshape(shape)
        at += n
    for name, c in batchnorm_names(w).items():
        state[f"{name}.weight"] = torch.ones(c, device=device)
        state[f"{name}.bias"] = torch.zeros(c, device=device)
        state[f"{name}.running_mean"] = torch.zeros(c, device=device)
        state[f"{name}.running_var"] = torch.ones(c, device=device)
    return state


def parameter_names(w: Widths) -> list[str]:
    """The trainable tensors (everything but the BatchNorm statistics)."""
    names = list(weight_shapes(w))
    for bn in batchnorm_names(w):
        names += [f"{bn}.weight", f"{bn}.bias"]
    return names


# -- forward ---------------------------------------------------------------------------

def _same(t: torch.Tensor) -> torch.Tensor:
    return t


class Net:
    """forward(P, obs, train) over a state dict P; `quant` is applied to the
    inputs and weights of every conv and bf16-class Dense layer."""

    def __init__(self, w: Widths, quant=None):
        self.w = w
        self.q = quant or _same

    def conv(self, x, weight, bias=None):
        k = weight.shape[-1]
        return F.conv2d(self.q(x), self.q(weight), bias, padding=k // 2)

    def dense(self, x, P, name, quantized=True):
        q = self.q if quantized else _same
        return F.linear(q(x), q(P[f"{name}.weight"]), P[f"{name}.bias"])

    @staticmethod
    def bn(x, P, name, train):
        if train:
            mean = x.mean(dim=(0, 2, 3))
            var = torch.clamp((x * x).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
        else:
            mean, var = P[f"{name}.running_mean"], P[f"{name}.running_var"]
        mul = torch.rsqrt(var + BN_EPS) * P[f"{name}.weight"]
        return (x - mean[None, :, None, None]) * mul[None, :, None, None] \
            + P[f"{name}.bias"][None, :, None, None]

    @staticmethod
    def pool(x):
        mean = x.mean(dim=(2, 3))
        var = ((x - mean[:, :, None, None]) ** 2).mean(dim=(2, 3))
        return torch.cat([mean, x.amax(dim=(2, 3)), torch.sqrt(var + 1e-10)], dim=1)

    def block(self, x, P, p, train):
        out = F.relu(self.bn(self.conv(x, P[f"{p}.conv1.weight"]), P, f"{p}.bn1", train))
        g = self.dense(F.relu(self.dense(self.pool(x), P, f"{p}.gp_fc1")), P, f"{p}.gp_fc2")
        out = out + g[:, :, None, None]
        out = self.bn(self.conv(out, P[f"{p}.conv2.weight"]), P, f"{p}.bn2", train)
        se = self.dense(F.relu(self.dense(out.mean(dim=(2, 3)), P, f"{p}.se_fc1")),
                        P, f"{p}.se_fc2")
        scale, shift = se.chunk(2, dim=1)
        out = out * torch.sigmoid(scale)[:, :, None, None] + shift[:, :, None, None]
        return F.relu(out + x)

    def forward(self, P, obs, train: bool):
        """(policy logits (B, 9, 9, 139), W/D/L logits (B, 3), score (B, 1))."""
        x = obs.reshape(obs.shape[0], self.w.obs_channels, 9, 9).float()
        x = F.relu(self.bn(self.conv(x, P["input_conv.weight"]), P, "input_bn", train))
        for i in range(self.w.num_blocks):
            x = self.block(x, P, f"block{i}", train)
        pol = F.relu(self.bn(self.conv(x, P["policy_conv1.weight"]), P, "policy_bn1", train))
        pol = self.conv(pol, P["policy_conv2.weight"], P["policy_conv2.bias"])
        pool = self.pool(x)
        v = F.relu(self.dense(pool, P, "value_fc1"))
        s = F.relu(self.dense(pool, P, "score_fc1"))
        # the two last Dense layers run in float32 in the model
        value = self.dense(v, P, "value_fc2", quantized=False)
        score = self.dense(s, P, "score_fc2", quantized=False)
        return pol.permute(0, 2, 3, 1), value, score

    def eval_rows(self, P, obs, rows: int = 512):
        """The eval forward in blocks of `rows` boards, without gradients."""
        outs = []
        with torch.no_grad():
            for i in range(0, obs.shape[0], rows):
                outs.append(self.forward(P, obs[i:i + rows], train=False))
        return tuple(torch.cat(parts) for parts in zip(*outs))


# -- operations and bytes --------------------------------------------------------------

def block_fc_macs(w: Widths) -> int:
    """Multiply-adds of a block's four in-block Dense layers, one board."""
    c, gpc, sec = w.channels, w.global_pool_channels, w.channels // w.se_reduction
    return 3 * c * gpc + gpc * c + c * sec + sec * 2 * c


def trunk_conv_flops(w: Widths) -> float:
    """The trunk's 3x3 convolutions in the blocks, one board: 2 x 81 x C*C*9
    multiply-adds each, two a block."""
    return w.num_blocks * 2 * 2.0 * SQUARES * w.channels * w.channels * 9


def forward_flops(w: Widths) -> float:
    """Every convolution and Dense layer of one board's forward (2 operations
    a multiply-add); the elementwise work is left out."""
    c = w.channels
    stem = 2.0 * SQUARES * w.obs_channels * c * 9
    fcs = w.num_blocks * 2.0 * block_fc_macs(w)
    policy = 2.0 * SQUARES * (c * w.policy_channels + w.policy_channels * SPATIAL_MOVE_TYPES)
    heads = 2.0 * (3 * c * w.value_fc_size + w.value_fc_size * 3
                   + 3 * c * w.score_fc_size + w.score_fc_size)
    return stem + trunk_conv_flops(w) + fcs + policy + heads


def trunk_bound_s(w: Widths, b: int) -> float:
    """The fused trunk's bound at B boards: the stem conv (its 50 planes)
    and one fused block per block, each bounded on its own, as chip_smoke.py
    bounds them."""
    c = w.channels
    stem = bound_s(2.0 * SQUARES * b * 9 * w.obs_channels * c,
                   2.0 * (SQUARES * b * w.obs_channels + 9 * w.obs_channels * c
                          + SQUARES * b * c))
    gpc, sec = w.global_pool_channels, c // w.se_reduction
    fc_bytes = 2.0 * block_fc_macs(w) + 4.0 * (gpc + c + sec + 2 * c + 4 * c)
    block = bound_s(2 * 2.0 * SQUARES * b * 9 * c * c + 2.0 * b * block_fc_macs(w),
                    2 * 2.0 * SQUARES * b * c + 2 * 2.0 * 9 * c * c + fc_bytes)
    return stem + w.num_blocks * block

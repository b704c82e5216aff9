"""Fused eval-mode GlobalPoolBias block (counterpart of
keisei_tpu/ops/fused_block.py:fused_gpbias_block, whose Pallas kernel it
replaces):

    h = relu(conv1(x) * s1 + b1) + gp_bias(pool3(x))
    z = conv2(h) * s2 + b2
    y = relu(z * sigmoid(se_scale(z)) + se_shift(z) + x)

with (s, b) the folded eval-mode BatchNorm affines in a (4, C) f32 array
[s1, b1, s2, b2]. On a CUDA tensor `fused_gpbias_block` launches the
hand-written sm_90a kernel (csrc/fused_block.cu), which keeps x, h and every
intermediate vector on the SM, or raises; only a CPU tensor takes the plain
version `fused_gpbias_block_reference`. `fused_gpbias_block.launches` counts
kernel launches.
"""

from __future__ import annotations

import torch

from . import _build
from .conv3x3 import conv3x3_taps_f32

__all__ = ["fused_gpbias_block", "fused_gpbias_block_reference"]

SUPPORTED_C = (128, 256)


def _check(x, w1, w2, bn, gp1_w, gp1_b, gp2_w, gp2_b, se1_w, se1_b, se2_w, se2_b) -> None:
    if x.dim() != 4 or tuple(x.shape[:2]) != (9, 9):
        raise ValueError(f"expected x (9, 9, B, C), got {tuple(x.shape)}")
    c = x.shape[3]
    gpc, sec = gp1_w.shape[-1], se1_w.shape[-1]
    shapes = {
        "w1": (w1, (3, 3, c, c)), "w2": (w2, (3, 3, c, c)), "bn_affine": (bn, (4, c)),
        "gp1_w": (gp1_w, (3 * c, gpc)), "gp1_b": (gp1_b, (gpc,)),
        "gp2_w": (gp2_w, (gpc, c)), "gp2_b": (gp2_b, (c,)),
        "se1_w": (se1_w, (c, sec)), "se1_b": (se1_b, (sec,)),
        "se2_w": (se2_w, (sec, 2 * c)), "se2_b": (se2_b, (2 * c,)),
    }
    for name, (t, shape) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device} but x on {x.device}")
        want = torch.float32 if name == "bn_affine" or name.endswith("_b") else torch.bfloat16
        if t.dtype != want:
            raise TypeError(f"{name} must be {want}, got {t.dtype}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"x must be bfloat16, got {x.dtype}")


def fused_gpbias_block_reference(x, w1, w2, bn_affine, gp1_w, gp1_b, gp2_w, gp2_b,
                                 se1_w, se1_b, se2_w, se2_b) -> torch.Tensor:
    """Plain version with the TPU kernel's rounding points: FC inputs and h
    are rounded to bf16, every sum is f32, the output is bf16."""
    _check(x, w1, w2, bn_affine, gp1_w, gp1_b, gp2_w, gp2_b, se1_w, se1_b, se2_w, se2_b)
    n, ch = x.shape[2], x.shape[3]
    bf16 = torch.bfloat16

    def fc(v, w, b):
        return v.to(bf16).float() @ w.float() + b

    xf = x.float().reshape(81, n, ch)
    s1, b1, s2, b2 = bn_affine
    h = torch.relu(conv3x3_taps_f32(x, w1).reshape(81, n, ch) * s1 + b1)

    mean = xf.mean(dim=0)
    amax = xf.amax(dim=0)
    var = ((xf - mean[None]) ** 2).mean(dim=0)
    pool = torch.cat([mean, amax, torch.sqrt(var + 1e-10)], dim=1)
    g = torch.relu(fc(pool, gp1_w, gp1_b))
    h = h + fc(g, gp2_w, gp2_b)[None]

    z = conv3x3_taps_f32(h.reshape(9, 9, n, ch).to(bf16), w2).reshape(81, n, ch)
    z = z * s2 + b2
    se = torch.relu(fc(z.mean(dim=0), se1_w, se1_b))
    se = fc(se, se2_w, se2_b)
    y = z * torch.sigmoid(se[:, :ch])[None] + se[:, ch:][None] + xf
    return torch.relu(y).reshape(9, 9, n, ch).to(bf16)


def fused_gpbias_block(x, w1, w2, bn_affine, gp1_w, gp1_b, gp2_w, gp2_b,
                       se1_w, se1_b, se2_w, se2_b) -> torch.Tensor:
    """Eval-mode GlobalPoolBias block; x (9, 9, B, C) bf16 -> same shape.

    Weights: convs (3, 3, C, C) and FC kernels (in, out) bf16; bn_affine
    (4, C) and FC biases f32.
    """
    args = (x, w1, w2, bn_affine, gp1_w, gp1_b, gp2_w, gp2_b, se1_w, se1_b, se2_w, se2_b)
    _check(*args)
    if x.device.type == "cpu":
        return fused_gpbias_block_reference(*args)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    n, ch = x.shape[2], x.shape[3]
    if ch not in SUPPORTED_C:
        raise ValueError(f"CUDA fused block takes C in {SUPPORTED_C}, got {ch}")
    if not all(t.is_contiguous() for t in args):
        raise ValueError("all fused block operands must be contiguous")
    lib = _build.load_library()
    out = torch.empty_like(x)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.keisei_fused_gpbias_block(
        *[t.data_ptr() for t in args], out.data_ptr(),
        n, ch, gp1_w.shape[1], se1_w.shape[1], stream)
    _build.check(lib, err, "fused_gpbias_block launch")
    fused_gpbias_block.launches += 1
    return out


fused_gpbias_block.launches = 0

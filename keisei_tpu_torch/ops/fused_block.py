"""Fused eval-mode GlobalPoolBias block (counterpart of
keisei_tpu/ops/fused_block.py:fused_gpbias_block, whose Pallas kernel it
replaces):

    h = relu(conv1(x) * s1 + b1) + gp_bias(pool3(x))
    z = conv2(h) * s2 + b2
    y = relu(z * sigmoid(se_scale(z)) + se_shift(z) + x)

with (s, b) the folded eval-mode BatchNorm affines in a (4, C) f32 array
[s1, b1, s2, b2]. On a CUDA tensor `fused_gpbias_block` makes one call into
csrc/fused_block.cu, which enqueues four hand-written sm_90a kernels (the
pool and gp FCs; conv1 and conv2 on the wgmma + TMA mainloop, whose CTA
computes 64 or 128 boards at one square; SE and residual), split at the two
reductions over a board's 81 squares, or raises; h (bf16), conv2's sums
(f32) and the pool bias cross device memory in scratch the wrapper
allocates as `block_plan` sizes it. Only a CPU tensor takes the plain version
`fused_gpbias_block_reference`. `fused_gpbias_block.launches` counts calls
that launched the kernels.

`fused_block_stage` is the block without SE cut after one stage, written in
f32 (counterpart of scripts/debug_fused_block.py:run_stage, the TPU bisect
harness, whose Pallas kernel it replaces): the block's own kernels with the
epilogue cut at the stage (csrc/fused_block_stage.cu), so a stage that
disagrees with its plain version `fused_block_stage_reference` points at the
production code. `fused_block_stage.launches` counts calls per stage.
"""

from __future__ import annotations

from collections import Counter
from typing import NamedTuple

import torch

from . import _build
from .conv3x3 import ConvRoute, conv3x3_taps_f32, wgmma_tile

__all__ = ["fused_gpbias_block", "fused_gpbias_block_reference", "fused_block_stage",
           "fused_block_stage_reference", "block_plan", "BlockPlan", "STAGES"]

SUPPORTED_C = (128, 256)
# the bisect harness's stop stages, in kernel order
STAGES = ("conv1", "bnrelu", "pool", "gpbias", "conv2")
# boards from which a pool CTA takes 4: every one of an H100's 132 SMs still gets a CTA
POOL_4_FROM = 4 * 132


class BlockPlan(NamedTuple):
    """What the wrapper decides of one block call at (n boards, c channels);
    grids and shared memory are the C launchers' (csrc/fused_block.cu)."""
    tile: ConvRoute       # the two convs' wgmma tile (boards x c, persistent)
    pool_boards: int      # boards per CTA of the pool kernel, 1 or 4
    g2_bytes: int         # scratch: the pool bias (n, c) f32
    h_bytes: int          # scratch: h (9, 9, n, c) bf16
    z_bytes: int          # scratch: conv2's sums (9, 9, n, c) f32

    @property
    def scratch_bytes(self) -> int:
        return self.g2_bytes + self.h_bytes + self.z_bytes


def block_plan(n: int, c: int, pool_boards: int | None = None) -> BlockPlan:
    """The launch of fused_gpbias_block for x (9, 9, n, c): a function of
    the shapes alone, with the pool kernel's boards per CTA fixed to
    `pool_boards` (1 or 4) or chosen from n.

    The convs take the tile the conv alone takes (`wgmma_tile`: all of c,
    64 boards while tiles are few waves, 128 beyond). The pool kernel gives
    a CTA 4 boards from n = POOL_4_FROM: the FC weights a CTA reads from L2
    (0.26 MB at c = 256) then serve 4 boards; below that one board per CTA
    keeps more SMs busy. scripts/profile_fused_forward.py times both."""
    if c not in SUPPORTED_C:
        raise ValueError(f"CUDA fused block takes C in {SUPPORTED_C}, got {c}")
    if n < 1:
        raise ValueError(f"need at least one board, got {n}")
    if pool_boards is None:
        pool_boards = 4 if n >= POOL_4_FROM else 1
    if pool_boards not in (1, 4):
        raise ValueError(f"pool_boards must be 1 or 4, got {pool_boards}")
    return BlockPlan(wgmma_tile(n, c), pool_boards, n * c * 4, 81 * n * c * 2, 81 * n * c * 4)


def _check(x, w1, w2, bn, gp1_w, gp1_b, gp2_w, gp2_b, se1_w=None, se1_b=None, se2_w=None,
           se2_b=None) -> None:
    """Shapes, devices and types of the block's operands; the stage harness
    passes no SE weights."""
    if x.dim() != 4 or tuple(x.shape[:2]) != (9, 9):
        raise ValueError(f"expected x (9, 9, B, C), got {tuple(x.shape)}")
    c = x.shape[3]
    gpc = gp1_w.shape[-1]
    shapes = {
        "w1": (w1, (3, 3, c, c)), "w2": (w2, (3, 3, c, c)), "bn_affine": (bn, (4, c)),
        "gp1_w": (gp1_w, (3 * c, gpc)), "gp1_b": (gp1_b, (gpc,)),
        "gp2_w": (gp2_w, (gpc, c)), "gp2_b": (gp2_b, (c,)),
    }
    if se1_w is not None:
        sec = se1_w.shape[-1]
        shapes.update({
            "se1_w": (se1_w, (c, sec)), "se1_b": (se1_b, (sec,)),
            "se2_w": (se2_w, (sec, 2 * c)), "se2_b": (se2_b, (2 * c,)),
        })
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


def _fc(v, w, b):
    """An in-block FC: input rounded to bf16, f32 sums."""
    return v.to(torch.bfloat16).float() @ w.float() + b


def _gp_bias(xf, gp1_w, gp1_b, gp2_w, gp2_b):
    """(81, B, C) f32 block input -> the (B, C) global-pool bias g2."""
    mean = xf.mean(dim=0)
    amax = xf.amax(dim=0)
    var = ((xf - mean[None]) ** 2).mean(dim=0)
    pool = torch.cat([mean, amax, torch.sqrt(var + 1e-10)], dim=1)
    return _fc(torch.relu(_fc(pool, gp1_w, gp1_b)), gp2_w, gp2_b)


def fused_gpbias_block_reference(x, w1, w2, bn_affine, gp1_w, gp1_b, gp2_w, gp2_b,
                                 se1_w, se1_b, se2_w, se2_b) -> torch.Tensor:
    """Plain version with the TPU kernel's rounding points: FC inputs and h
    are rounded to bf16, every sum is f32, the output is bf16."""
    _check(x, w1, w2, bn_affine, gp1_w, gp1_b, gp2_w, gp2_b, se1_w, se1_b, se2_w, se2_b)
    n, ch = x.shape[2], x.shape[3]
    bf16 = torch.bfloat16
    xf = x.float().reshape(81, n, ch)
    s1, b1, s2, b2 = bn_affine
    h = torch.relu(conv3x3_taps_f32(x, w1).reshape(81, n, ch) * s1 + b1)
    h = h + _gp_bias(xf, gp1_w, gp1_b, gp2_w, gp2_b)[None]

    z = conv3x3_taps_f32(h.reshape(9, 9, n, ch).to(bf16), w2).reshape(81, n, ch)
    z = z * s2 + b2
    se = torch.relu(_fc(z.mean(dim=0), se1_w, se1_b))
    se = _fc(se, se2_w, se2_b)
    y = z * torch.sigmoid(se[:, :ch])[None] + se[:, ch:][None] + xf
    return torch.relu(y).reshape(9, 9, n, ch).to(bf16)


def _launch_plan(args: tuple, pool_boards: int | None = None) -> BlockPlan:
    """The plan for CUDA operands, or raise on what the kernels do not take."""
    x = args[0]
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.shape[3] not in SUPPORTED_C:
        raise ValueError(f"CUDA fused block takes C in {SUPPORTED_C}, got {x.shape[3]}")
    if not all(t.is_contiguous() for t in args):
        raise ValueError("all fused block operands must be contiguous")
    return block_plan(x.shape[2], x.shape[3], pool_boards)


def fused_gpbias_block(x, w1, w2, bn_affine, gp1_w, gp1_b, gp2_w, gp2_b,
                       se1_w, se1_b, se2_w, se2_b, *,
                       pool_boards: int | None = None) -> torch.Tensor:
    """Eval-mode GlobalPoolBias block; x (9, 9, B, C) bf16 -> same shape.

    Weights: convs (3, 3, C, C) and FC kernels (in, out) bf16; bn_affine
    (4, C) and FC biases f32. `pool_boards` fixes the pool kernel's boards
    per CTA (`block_plan`; a launch parameter, as the TPU kernel's
    batch_tile is: the result does not depend on it).
    """
    args = (x, w1, w2, bn_affine, gp1_w, gp1_b, gp2_w, gp2_b, se1_w, se1_b, se2_w, se2_b)
    _check(*args)
    if x.device.type == "cpu":
        return fused_gpbias_block_reference(*args)
    n, ch = x.shape[2], x.shape[3]
    plan = _launch_plan(args, pool_boards)
    lib = _build.load_library()
    out = torch.empty_like(x)
    scratch = torch.empty(plan.scratch_bytes, dtype=torch.uint8, device=x.device)
    g2, h, z = scratch.split((plan.g2_bytes, plan.h_bytes, plan.z_bytes))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.keisei_fused_gpbias_block(
        *[t.data_ptr() for t in args], out.data_ptr(), g2.data_ptr(), h.data_ptr(), z.data_ptr(),
        n, ch, gp1_w.shape[1], se1_w.shape[1], plan.tile.boards, plan.pool_boards, stream)
    _build.check(lib, err, "fused_gpbias_block launch")
    fused_gpbias_block.launches += 1
    return out


fused_gpbias_block.launches = 0


def fused_block_stage_reference(x, w1, w2, bn_affine, gp1_w, gp1_b, gp2_w, gp2_b, *,
                                stage: str) -> torch.Tensor:
    """Plain version of the stage harness: the block without SE up to
    `stage`, that stage as (9, 9, B, C) f32 (conv1 and conv2 the raw f32
    sums, conv2's over bf16(h); pool the f32 mean broadcast over the 81
    squares; gpbias h before its bf16 rounding)."""
    _check(x, w1, w2, bn_affine, gp1_w, gp1_b, gp2_w, gp2_b)
    if stage not in STAGES:
        raise ValueError(f"stage must be one of {STAGES}, got {stage!r}")
    n, ch = x.shape[2], x.shape[3]
    xf = x.float().reshape(81, n, ch)
    if stage == "pool":
        return xf.mean(dim=0).expand(81, n, ch).reshape(9, 9, n, ch).contiguous()
    h = conv3x3_taps_f32(x, w1)
    if stage == "conv1":
        return h
    h = torch.relu(h * bn_affine[0] + bn_affine[1])
    if stage == "bnrelu":
        return h
    h = h + _gp_bias(xf, gp1_w, gp1_b, gp2_w, gp2_b).reshape(1, 1, n, ch)
    if stage == "gpbias":
        return h
    return conv3x3_taps_f32(h.to(torch.bfloat16), w2)


def fused_block_stage(x, w1, w2, bn_affine, gp1_w, gp1_b, gp2_w, gp2_b, *,
                      stage: str) -> torch.Tensor:
    """The fused block without SE cut after `stage` (one of STAGES): x (9, 9,
    B, C) bf16 and the block's weights up to gp2_b -> (9, 9, B, C) f32."""
    args = (x, w1, w2, bn_affine, gp1_w, gp1_b, gp2_w, gp2_b)
    _check(*args)
    if stage not in STAGES:
        raise ValueError(f"stage must be one of {STAGES}, got {stage!r}")
    if x.device.type == "cpu":
        return fused_block_stage_reference(*args, stage=stage)
    n, ch = x.shape[2], x.shape[3]
    plan = _launch_plan(args)
    lib = _build.load_library()
    out = torch.empty((9, 9, n, ch), dtype=torch.float32, device=x.device)
    scratch = torch.empty(plan.g2_bytes + plan.h_bytes, dtype=torch.uint8, device=x.device)
    g2, h = scratch.split((plan.g2_bytes, plan.h_bytes))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.keisei_fused_block_stage(*[t.data_ptr() for t in args], out.data_ptr(),
                                       g2.data_ptr(), h.data_ptr(), n, ch, gp1_w.shape[1],
                                       STAGES.index(stage), plan.tile.boards, plan.pool_boards,
                                       stream)
    _build.check(lib, err, f"fused_block_stage({stage}) launch")
    fused_block_stage.launches[stage] += 1
    return out


fused_block_stage.launches = Counter()

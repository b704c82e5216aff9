"""int8 eval-mode GlobalPoolBias block (counterpart of
keisei_tpu/ops/qblock.py:quantized_gpbias_block, whose Pallas kernel it
replaces), with its host helpers:

    xf = xq * sx                                       (dequantized input)
    h  = relu(acc(conv1(xq)) * (sx * m1) + b1) + gp_bias(pool3(xf))
    hq, sh = quantize_tile(h)
    z  = acc(conv2(hq)) * (sh * m2) + b2
    y  = relu(z * sigmoid(se_scale(z)) + se_shift(z) + xf)
    yq, sy = quantize_tile(y)

The convs multiply int8 by int8 and sum exactly in int32; `m = s * ws` are
the folded eval BatchNorm multipliers with the per-output-channel weight
scales folded in (bn_affine rows [m1, b1, m2, b2]). Activations carry one
scale per tile of `batch_tile` boards: `quantize_tile` takes the amax of
|v| over the whole tile, scale = amax / 127 (1.0 when amax is 0), and
rounds v / scale half to even, clipped to +-127.

The TPU kernel works on a banded (145, B, 3C) padded-flat layout that feeds
its K >= 512 int8 matrix unit. The port computes the same function on its
own layout: activations (9, 9, B, C) int8 with scales (B / batch_tile,)
f32, conv weights (3, 3, Cout, Cin) int8 (K-contiguous per output channel,
what the s8 tensor-core MMA reads without a transpose) with scales (Cout,).

On a CUDA tensor `quantized_gpbias_block` launches the hand-written sm_90a
kernels (csrc/qblock.cu) or raises; only a CPU tensor takes the plain
version `quantized_gpbias_block_reference`. `quantized_gpbias_block.launches`
counts launches of the block (three kernels each, see csrc/qblock.cu).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build

__all__ = ["quantized_gpbias_block", "quantized_gpbias_block_reference", "pack_quantized",
           "unpack_dequantized", "quantize_conv_weights", "int8_batch_tile"]

SUPPORTED_C = (128, 256)


def int8_batch_tile(n: int) -> int:
    """The quantization tile for a batch of n boards, as JAX's
    make_quantized_forward picks it at its default batch_tile: 32 when 32
    divides n. Its fallback, the largest multiple-of-32 divisor of n up to
    256, exists only when 32 divides n, so any other n is refused."""
    if n % 32:
        raise ValueError(f"rollout_forward='int8' needs a batch size divisible by 32 (got {n})")
    return 32


def quantize_conv_weights(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(3, 3, Cin, Cout) float -> ((3, 3, Cout, Cin) int8, (Cout,) f32).

    Per-output-channel symmetric: ws = max(amax / 127, 1e-12), wq =
    clip(round(w / ws), -127, 127), round half to even."""
    w = w.float()
    ws = torch.clamp_min(w.abs().amax(dim=(0, 1, 2)) / 127.0, 1e-12)
    wq = torch.clamp(torch.round(w / ws), -127, 127).to(torch.int8)
    return wq.permute(0, 1, 3, 2).contiguous(), ws


def _tile_scales(amax: torch.Tensor) -> torch.Tensor:
    # a tensor divisor: CUDA divides by a Python scalar through its
    # reciprocal, one ulp away from the IEEE quotient the kernel takes
    return torch.where(amax > 0, amax / torch.full_like(amax, 127.0), torch.ones_like(amax))


def _quantize_tiles(v: torch.Tensor, bt: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(81, B, C) f32 -> ((81, B, C) int8, (B / bt,) f32): one scale per
    tile of bt boards."""
    _, n, ch = v.shape
    scale = _tile_scales(v.abs().reshape(81, n // bt, bt, ch).amax(dim=(0, 2, 3)))
    q = torch.round(v / scale.repeat_interleave(bt)[None, :, None])
    return torch.clamp(q, -127, 127).to(torch.int8), scale


def _check_tile(n: int, bt: int) -> None:
    if bt < 1 or n % bt:
        raise ValueError(f"B={n} not divisible by batch_tile={bt}")


def pack_quantized(x: torch.Tensor, batch_tile: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(9, 9, B, C) float -> ((9, 9, B, C) int8, (B / batch_tile,) f32)."""
    n, ch = x.shape[2], x.shape[3]
    _check_tile(n, batch_tile)
    q, scale = _quantize_tiles(x.float().reshape(81, n, ch), batch_tile)
    return q.reshape(9, 9, n, ch), scale


def unpack_dequantized(xq: torch.Tensor, sx: torch.Tensor, batch_tile: int) -> torch.Tensor:
    """((9, 9, B, C) int8, (B / batch_tile,) f32) -> (9, 9, B, C) f32."""
    _check_tile(xq.shape[2], batch_tile)
    return xq.float() * sx.repeat_interleave(batch_tile)[None, None, :, None]


def _check(xq, sx, wq1, wq2, bn, gp1_w, gp1_b, gp2_w, gp2_b, se1_w, se1_b, se2_w, se2_b,
           batch_tile: int) -> None:
    if xq.dim() != 4 or tuple(xq.shape[:2]) != (9, 9):
        raise ValueError(f"expected xq (9, 9, B, C), got {tuple(xq.shape)}")
    n, c = xq.shape[2], xq.shape[3]
    _check_tile(n, batch_tile)
    gpc, sec = gp1_w.shape[-1], se1_w.shape[-1]
    shapes = {
        "xq": (xq, (9, 9, n, c), torch.int8), "sx": (sx, (n // batch_tile,), torch.float32),
        "wq1": (wq1, (3, 3, c, c), torch.int8), "wq2": (wq2, (3, 3, c, c), torch.int8),
        "bn_affine": (bn, (4, c), torch.float32),
        "gp1_w": (gp1_w, (3 * c, gpc), torch.bfloat16), "gp1_b": (gp1_b, (gpc,), torch.float32),
        "gp2_w": (gp2_w, (gpc, c), torch.bfloat16), "gp2_b": (gp2_b, (c,), torch.float32),
        "se1_w": (se1_w, (c, sec), torch.bfloat16), "se1_b": (se1_b, (sec,), torch.float32),
        "se2_w": (se2_w, (sec, 2 * c), torch.bfloat16),
        "se2_b": (se2_b, (2 * c,), torch.float32),
    }
    for name, (t, shape, dtype) in shapes.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
        if t.device != xq.device:
            raise ValueError(f"{name} on {t.device} but xq on {xq.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")


def _qconv_taps_exact(q: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """SAME 3x3 conv of (9, 9, B, Cin) int8 by (3, 3, Cout, Cin) int8 ->
    (81, B, Cout) f64 holding the exact integer sums (f64 is exact below
    2**53; int8 products on the CPU would wrap in int8 and CUDA has no
    integer matmul in torch)."""
    n, cin = q.shape[2], q.shape[3]
    xp = F.pad(q.double(), (0, 0, 0, 0, 1, 1, 1, 1))
    wd = w.double()
    acc = torch.zeros((81 * n, w.shape[2]), dtype=torch.float64, device=q.device)
    for di in range(3):
        for dj in range(3):
            acc += xp[di:di + 9, dj:dj + 9].reshape(81 * n, cin) @ wd[di, dj].t()
    return acc.reshape(81, n, -1)


def _qconv_taps(q: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The exact sums rounded to f32 once, as the int32 accumulator is
    converted."""
    return _qconv_taps_exact(q, w).float()


def quantized_gpbias_block_reference(xq, sx, wq1, wq2, bn_affine, gp1_w, gp1_b, gp2_w, gp2_b,
                                     se1_w, se1_b, se2_w, se2_b, *, batch_tile: int = 32
                                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version with the TPU kernel's arithmetic: exact integer convs,
    FC inputs rounded to bf16, f32 elsewhere, tile-wide scales."""
    args = (xq, sx, wq1, wq2, bn_affine, gp1_w, gp1_b, gp2_w, gp2_b, se1_w, se1_b, se2_w, se2_b)
    _check(*args, batch_tile)
    n, ch = xq.shape[2], xq.shape[3]
    bt = batch_tile
    bf16 = torch.bfloat16

    def fc(v, w, b):
        return v.to(bf16).float() @ w.float() + b

    m1, b1, m2, b2 = bn_affine
    sx_b = sx.repeat_interleave(bt)                                  # (B,)
    xf = xq.reshape(81, n, ch).float() * sx_b[None, :, None]
    mean = xf.sum(dim=0) / 81.0
    amax = xf.amax(dim=0).clamp_min(0.0)       # the TPU's max includes the zero border
    var = ((xf - mean[None]) ** 2).sum(dim=0) / 81.0
    pool = torch.cat([mean, amax, torch.sqrt(var + 1e-10)], dim=1)
    g2 = fc(torch.relu(fc(pool, gp1_w, gp1_b)), gp2_w, gp2_b)

    h = _qconv_taps(xq, wq1) * (sx_b[:, None] * m1)[None] + b1
    h = torch.relu(h) + g2[None]
    hq, sh = _quantize_tiles(h, bt)

    z = _qconv_taps(hq.reshape(9, 9, n, ch), wq2)
    z = z * (sh.repeat_interleave(bt)[:, None] * m2)[None] + b2
    se = fc(torch.relu(fc(z.sum(dim=0) / 81.0, se1_w, se1_b)), se2_w, se2_b)
    y = torch.relu(z * torch.sigmoid(se[:, :ch])[None] + se[:, ch:][None] + xf)
    yq, sy = _quantize_tiles(y, bt)
    return yq.reshape(9, 9, n, ch), sy


def quantized_gpbias_block(xq, sx, wq1, wq2, bn_affine, gp1_w, gp1_b, gp2_w, gp2_b,
                           se1_w, se1_b, se2_w, se2_b, *, batch_tile: int = 32
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """int8 GlobalPoolBias block: xq (9, 9, B, C) int8 and sx (B / bt,) f32
    -> (yq (9, 9, B, C) int8, sy (B / bt,) f32).

    Weights: wq1, wq2 (3, 3, C, C) int8 as quantize_conv_weights lays them
    out; bn_affine (4, C) f32 rows [s1 * ws1, b1, s2 * ws2, b2]; FC kernels
    (in, out) bf16 and their biases f32.
    """
    args = (xq, sx, wq1, wq2, bn_affine, gp1_w, gp1_b, gp2_w, gp2_b, se1_w, se1_b, se2_w, se2_b)
    _check(*args, batch_tile)
    if xq.device.type == "cpu":
        return quantized_gpbias_block_reference(*args, batch_tile=batch_tile)
    if xq.device.type != "cuda":
        raise ValueError(f"unsupported device {xq.device}")
    n, ch = xq.shape[2], xq.shape[3]
    if ch not in SUPPORTED_C:
        raise ValueError(f"CUDA int8 block takes C in {SUPPORTED_C}, got {ch}")
    if not all(t.is_contiguous() for t in args):
        raise ValueError("all int8 block operands must be contiguous")
    lib = _build.load_library()
    yq = torch.empty_like(xq)
    sy = torch.empty_like(sx)
    # f32 scratch between the three kernels: h, then y, and per-board maxima
    act = torch.empty((9, 9, n, ch), dtype=torch.float32, device=xq.device)
    board_max = torch.empty((2, n), dtype=torch.float32, device=xq.device)
    stream = torch.cuda.current_stream(xq.device).cuda_stream
    err = lib.keisei_quantized_gpbias_block(
        *[t.data_ptr() for t in args], yq.data_ptr(), sy.data_ptr(), act.data_ptr(),
        board_max.data_ptr(), n, ch, gp1_w.shape[1], se1_w.shape[1], batch_tile, stream)
    _build.check(lib, err, "quantized_gpbias_block launch")
    quantized_gpbias_block.launches += 1
    return yq, sy


quantized_gpbias_block.launches = 0

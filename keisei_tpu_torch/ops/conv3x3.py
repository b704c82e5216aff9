"""SAME 3x3 convolution in the (9, 9, B, C) layout (counterpart of
keisei_tpu/ops/conv3x3.py:conv3x3_hwbc, whose Pallas kernel it replaces).

On a CUDA tensor `conv3x3_hwbc` launches the hand-written sm_90a kernel
(csrc/conv3x3.cu) or raises; only a CPU tensor takes the plain PyTorch
version, `conv3x3_hwbc_reference`, which does the same nine f32 tap GEMMs.
`conv3x3_hwbc.launches` counts kernel launches.

`conv3x3_bpc` is the same conv with 1, 2 or 4 boards per CTA (counterpart of
scripts/profile_pallas_conv.py:pallas_conv, whose grid step holds b_t
boards): every weight slice read from L2 serves that many boards. One board
per CTA is `conv3x3_hwbc`'s kernel, which the main path keeps.
`conv3x3_bpc.launches` counts launches per boards-per-CTA.
"""

from __future__ import annotations

from collections import Counter

import torch
import torch.nn.functional as F

from . import _build

__all__ = ["conv3x3_hwbc", "conv3x3_hwbc_reference", "conv3x3_bpc", "pick_batch_tile",
           "BOARDS_PER_CTA"]

SUPPORTED_COUT = (128, 256)
BOARDS_PER_CTA = (1, 2, 4)


def pick_batch_tile(n: int, preferred: int = 16) -> int:
    """Largest divisor of n that is <= preferred (the JAX kernel's grid
    tile). The CUDA kernel tiles one board per CTA and needs none; kept so
    callers written against the JAX signature port unchanged."""
    bt = min(preferred, n)
    while n % bt:
        bt -= 1
    return bt


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 4 or tuple(x.shape[:2]) != (9, 9):
        raise ValueError(f"expected x (9, 9, B, Cin), got {tuple(x.shape)}")
    if w.dim() != 4 or tuple(w.shape[:2]) != (3, 3) or w.shape[2] != x.shape[3]:
        raise ValueError(f"kernel/activation mismatch: {tuple(w.shape)} vs {tuple(x.shape)}")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"x and w must be bfloat16, got {x.dtype} and {w.dtype}")
    if x.device != w.device:
        raise ValueError(f"x on {x.device} but w on {w.device}")


def conv3x3_taps_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Nine (81*B, Cin) @ (Cin, Cout) tap GEMMs in float32 on a zero-padded
    (11, 11, B, Cin) copy -> the f32 sum, (9, 9, B, Cout)."""
    n, cin = x.shape[2], x.shape[3]
    xp = F.pad(x.float(), (0, 0, 0, 0, 1, 1, 1, 1))
    wf = w.float()
    acc = torch.zeros((81 * n, w.shape[3]), dtype=torch.float32, device=x.device)
    for di in range(3):
        for dj in range(3):
            acc += xp[di:di + 9, dj:dj + 9].reshape(81 * n, cin) @ wf[di, dj]
    return acc.reshape(9, 9, n, -1)


def conv3x3_hwbc_reference(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version: the f32 tap sum, one bf16 rounding at the end."""
    _check(x, w)
    return conv3x3_taps_f32(x, w).to(torch.bfloat16)


def _conv_cuda(x: torch.Tensor, w: torch.Tensor, boards_per_cta: int) -> torch.Tensor:
    """Launch csrc/conv3x3.cu's kernel for boards_per_cta boards per CTA."""
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    n, cin, cout = x.shape[2], x.shape[3], w.shape[3]
    if cout not in SUPPORTED_COUT or cin > 256:
        raise ValueError(f"CUDA conv3x3 takes Cout in {SUPPORTED_COUT} and Cin <= 256, "
                         f"got Cin={cin} Cout={cout}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("x and w must be contiguous")
    lib = _build.load_library()
    out = torch.empty((9, 9, n, cout), dtype=torch.bfloat16, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.keisei_conv3x3_bpc(x.data_ptr(), w.data_ptr(), out.data_ptr(), n, cin, cout,
                                 boards_per_cta, stream)
    _build.check(lib, err, f"conv3x3 ({boards_per_cta} boards per CTA) launch")
    return out


def conv3x3_hwbc(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """SAME 3x3 conv: x (9, 9, B, Cin) bf16, w (3, 3, Cin, Cout) bf16 ->
    (9, 9, B, Cout) bf16, f32 accumulation."""
    _check(x, w)
    if x.device.type == "cpu":
        return conv3x3_hwbc_reference(x, w)
    out = _conv_cuda(x, w, 1)
    conv3x3_hwbc.launches += 1
    return out


conv3x3_hwbc.launches = 0


def conv3x3_bpc(x: torch.Tensor, w: torch.Tensor, *, boards_per_cta: int) -> torch.Tensor:
    """conv3x3_hwbc's function with `boards_per_cta` boards per CTA (one of
    BOARDS_PER_CTA); the plain version is conv3x3_hwbc_reference."""
    _check(x, w)
    if boards_per_cta not in BOARDS_PER_CTA:
        raise ValueError(f"boards_per_cta must be one of {BOARDS_PER_CTA}, got {boards_per_cta}")
    if x.device.type == "cpu":
        return conv3x3_hwbc_reference(x, w)
    out = _conv_cuda(x, w, boards_per_cta)
    conv3x3_bpc.launches[boards_per_cta] += 1
    return out


conv3x3_bpc.launches = Counter()

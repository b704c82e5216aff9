"""The direct 3x3 conv with 1, 2 or 4 boards per CTA on the card, against
cuDNN (counterpart of scripts/profile_pallas_conv.py, whose Pallas kernel
pallas_conv it replaces: there a grid step holds b_t boards, here a CTA
holds boards_per_cta boards, and every weight slice it reads from L2 serves
that many boards).

    python -m keisei_tpu_torch.scripts.profile_direct_conv

prints the card's name and power limit, the check of each boards-per-CTA
kernel against the plain version at B=8 (relative error, as the TPU script
checks its kernel against XLA's conv), then an 80-conv chain (x <- conv(x,
w) * 0.5, 80 distinct weights, B=1024, C=256) per boards-per-CTA and through
cuDNN (F.conv2d, bf16, channels_last) in place of the TPU script's XLA conv:
ms per chain, TFLOP/s and the ratio to cuDNN. Needs a CUDA device; exits
non-zero without one.
"""

from __future__ import annotations

import sys

import torch
import torch.nn.functional as F

from ..ops.conv3x3 import BOARDS_PER_CTA, conv3x3_bpc, conv3x3_hwbc_reference
from ..utils.timing import card
from .profile_conv_alternatives import chain_ms

B = 1024
C = 256
BLOCKS = 80
CHECK_B = 8


def check(device, c: int = C) -> dict[int, float]:
    """Each boards-per-CTA kernel against the plain version at B=8 (and at
    B=7, a partial last CTA): max |got - ref| / max |ref| < 0.02, the TPU
    script's bound, and within rtol = atol = 0.05. Raises on a
    disagreement; returns the relative errors at B=8."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(9, 9, CHECK_B, c, generator=g).to(torch.bfloat16).to(device)
    w = (torch.randn(3, 3, c, c, generator=g) * 0.05).to(torch.bfloat16).to(device)
    errs = {}
    for bpc in BOARDS_PER_CTA:
        for xb in (x, x[:, :, :7].contiguous()):
            err = compare_conv(bpc, conv3x3_bpc(xb, w, boards_per_cta=bpc),
                               conv3x3_hwbc_reference(xb, w))
            errs.setdefault(bpc, err)
    return errs


def compare_conv(bpc: int, got: torch.Tensor, ref: torch.Tensor) -> float:
    """The bound for conv3x3_bpc: max |got - ref| / max |ref| < 0.02 and
    rtol = atol = 0.05. Raises outside it; returns the relative error."""
    got, ref = got.float(), ref.float()
    err = float((got - ref).abs().max() / ref.abs().max())
    if err >= 0.02 or not torch.allclose(got, ref, rtol=0.05, atol=0.05):
        raise AssertionError(f"conv3x3_bpc({bpc}) B={got.shape[2]} disagrees with the plain "
                             f"version: rel err {err:.5f}")
    return err


def measure(device, b: int = B, c: int = C, blocks: int = BLOCKS, iters: int = 3) -> dict:
    """ms per chain of `blocks` convs (x <- conv(x, w) * 0.5) at (b, c) for
    each boards-per-CTA and through cuDNN, and the chain's conv FLOP."""
    g = torch.Generator().manual_seed(0)
    ws = [(torch.randn(3, 3, c, c, generator=g) * 0.02).to(torch.bfloat16).to(device)
          for _ in range(blocks)]
    x0 = torch.full((9, 9, b, c), 0.01, dtype=torch.bfloat16, device=device)
    res = {"flop": 2.0 * 9 * 81 * b * c * c * blocks}
    for bpc in BOARDS_PER_CTA:
        res[bpc] = chain_ms(lambda x, w, bpc=bpc: conv3x3_bpc(x, w, boards_per_cta=bpc), ws, x0,
                            iters)
    w_cl = [w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last) for w in ws]
    del ws
    x0 = x0.permute(2, 3, 0, 1).contiguous(memory_format=torch.channels_last)
    res["cudnn"] = chain_ms(lambda x, w: F.conv2d(x, w, padding=1), w_cl, x0, iters)
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_direct_conv: no CUDA device", file=sys.stderr)
        return 2
    print(card())
    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    for bpc, err in check(dev).items():
        print(f"conv3x3_bpc({bpc})-vs-plain conv rel err: {err:.5f}")
    r = measure(dev)
    print(f"cuDNN conv x{BLOCKS} B={B}: {r['cudnn']:.2f} ms "
          f"({r['flop'] / r['cudnn'] / 1e9:.1f} TFLOP/s)")
    for bpc in BOARDS_PER_CTA:
        print(f"conv3x3_bpc x{BLOCKS} B={B} boards_per_cta={bpc}: {r[bpc]:.2f} ms "
              f"({r['flop'] / r[bpc] / 1e9:.1f} TFLOP/s; vs cuDNN {r['cudnn'] / r[bpc]:.2f}x)")
    return 0


if __name__ == "__main__":
    sys.exit(main())

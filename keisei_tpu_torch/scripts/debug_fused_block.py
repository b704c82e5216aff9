"""Bisect the fused block kernel stage by stage on the card (counterpart of
scripts/debug_fused_block.py, whose Pallas kernel run_stage it replaces).

`fused_block_stage` (ops/fused_block.py) runs the block's own kernels
(csrc/fused_block_stage.cu: the pool kernel and the wgmma convs of
csrc/fused_block.cu) cut after one stage (conv1, bnrelu, pool, gpbias,
conv2; the block without SE), the stage written in f32; each is held
against the same stage of the plain version. A stage that disagrees points
at the production kernels' code up to that stage.

    python -m keisei_tpu_torch.scripts.debug_fused_block

prints the card's name and power limit, then per stage the max abs error
and the error relative to the largest |value|, at the TPU script's B=32,
C=128 and at the flagship's C=256. Needs a CUDA device; exits non-zero
without one.
"""

from __future__ import annotations

import sys

import torch

from ..ops.fused_block import STAGES, fused_block_stage, fused_block_stage_reference
from ..utils.timing import card, cuda_ms, graph_ms

B, C, GPC = 32, 128, 64
# f32 stages before any bf16 rounding: max abs error <= 1e-4 x max |ref|
# (f32 sums in another order); stages after one (gpbias rounds the FC
# inputs, conv2 h): rtol = atol = 0.05
EXACT_STAGES = ("conv1", "bnrelu", "pool")


def stage_inputs(b: int, c: int, gpc: int, device, seed: int = 0) -> tuple:
    """The TPU script's operands, made from `seed`: x ~ N(0, 0.5^2), convs
    N(0, 0.05^2), bn rows [s, b, s, b] with s = exp(N(0, 0.1^2)), b =
    N(0, 0.1^2), FC weights N(0, 0.1^2), biases 0.05 and 0.01."""
    g = torch.Generator().manual_seed(seed)
    bf = torch.bfloat16
    x = (torch.randn(9, 9, b, c, generator=g) * 0.5).to(bf)
    w1, w2 = [(torch.randn(3, 3, c, c, generator=g) * 0.05).to(bf) for _ in range(2)]
    s1 = torch.exp(torch.randn(c, generator=g) * 0.1)
    b1 = torch.randn(c, generator=g) * 0.1
    bn = torch.stack([s1, b1, s1, b1])
    gp1w = (torch.randn(3 * c, gpc, generator=g) * 0.1).to(bf)
    gp2w = (torch.randn(gpc, c, generator=g) * 0.1).to(bf)
    args = (x, w1, w2, bn, gp1w, torch.full((gpc,), 0.05), gp2w, torch.full((c,), 0.01))
    return tuple(t.to(device) for t in args)


def run(device, b: int = B, c: int = C, gpc: int = GPC, time_it: bool = False) -> dict:
    """Per stage: the kernel's max abs error against the plain version, the
    error relative to max |ref|, and with time_it the kernel's ms (from a
    CUDA graph: a stage at B=32 runs for less time than its launch from
    Python) and the plain version's. Raises if a stage is outside its bound."""
    args = stage_inputs(b, c, gpc, device)
    res = {}
    for stage in STAGES:
        got = fused_block_stage(*args, stage=stage)
        ref = fused_block_stage_reference(*args, stage=stage)
        err = float((got - ref).abs().max())
        rel = err / (float(ref.abs().max()) + 1e-9)
        ok = (rel <= 1e-4 if stage in EXACT_STAGES
              else torch.allclose(got, ref, rtol=0.05, atol=0.05))
        if not ok:
            raise AssertionError(f"fused_block_stage({stage}) B={b} C={c} disagrees with its "
                                 f"plain version: max abs err {err:.4g} (rel {rel:.4g})")
        res[stage] = {"max_abs_err": err, "rel_err": rel}
        if time_it:
            res[stage]["ms"] = graph_ms(lambda s=stage: fused_block_stage(*args, stage=s),
                                        counters=(fused_block_stage.launches,))
            res[stage]["plain_ms"] = cuda_ms(
                lambda s=stage: fused_block_stage_reference(*args, stage=s), iters=5)
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("debug_fused_block: no CUDA device", file=sys.stderr)
        return 2
    print(card())
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    for c in (C, 256):
        print(f"B={B} C={c}")
        for stage, r in run(dev, B, c).items():
            print(f"{stage:8s}: max abs err {r['max_abs_err']:10.4g}  (rel {r['rel_err']:.4g})")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The fused b40c256 forward on the card, and where its time goes
(counterpart of scripts/profile_fused_forward.py, which times the fused
Pallas forward against the flax forward on the TPU).

    python -m keisei_tpu_torch.scripts.profile_fused_forward [B ...]

For each batch B (default 64 256 1024) prints, after the card's name and
power limit:

- the fused forward against the eager bf16 model on random weights made from
  a seed: max abs error of the policy logits, top-1 agreement, and both
  forwards' ms (CUDA events around whole forwards, host launches included);
- the input conv's times: `conv3x3_hwbc` on the 50 observation planes (the
  zero pad to 64 channels inside the timed call), the forward's own call on
  planes already padded, the mma.sync kernel (`conv3x3_bpc`, one board per
  CTA) and cuDNN (`F.conv2d`, bf16, channels_last) on the 50 and on the 64;
  and, outside the conv, the forward's fill of its padded planes against the
  one cast copy unpadded planes would take;
- one 256 -> 256 conv through `conv3x3_hwbc` (the wgmma kernel alone);
- the fused block: ms per call over a trunk of 40 distinct weight sets,
  replayed from one CUDA graph (a block is shorter than its launches from
  Python), the device time of each of its kernels from a torch.profiler
  (CUPTI) trace of the same trunk, and both with 1 and with 4 boards per CTA
  of the pool kernel.

Kernel times shorter than a launch come from `utils/timing.py:graph_ms`.
Needs a CUDA device; exits non-zero without one.
"""

from __future__ import annotations

import functools
import math
import sys

import torch
import torch.nn.functional as F

from ..models.fused_infer import make_fused_forward, padded_planes
from ..models.registry import build_model
from ..ops.conv3x3 import conv3x3_bpc, conv3x3_hwbc, pad_channels
from ..ops.fused_block import block_plan, fused_gpbias_block
from ..utils.timing import card, cuda_ms, graph_ms, trace_kernel_us, traced_kernel_ms
from .profile_direct_conv import cudnn_w, cudnn_x

BATCHES = (64, 256, 1024)
C, GPC, SEC, BLOCKS, PLANES = 256, 128, 16, 40, 50   # b40c256
# the block's four kernels, by a pattern of the name the profiler reports
BLOCK_KERNELS = (("K0_pool", r"gp_pool_kernel"), ("K1_conv1", r"BlockEpilogue<3>"),
                 ("K2_conv2", r"BlockEpilogue<0>"), ("K3_se", r"se_residual_kernel"))


def block_weights(c: int, gpc: int, sec: int, g: torch.Generator, dev) -> tuple:
    """One block's weights (w1, w2, bn, gp and SE FCs) from the generator."""
    def rnd(*shape, scale, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(dtype)

    s = 1.0 / math.sqrt(9 * c)
    ones = torch.ones(c, device=dev)
    f32 = torch.float32
    bn = torch.stack([ones + rnd(c, scale=0.1, dtype=f32), rnd(c, scale=0.1, dtype=f32),
                      ones + rnd(c, scale=0.1, dtype=f32), rnd(c, scale=0.1, dtype=f32)])
    return (rnd(3, 3, c, c, scale=s), rnd(3, 3, c, c, scale=s), bn.contiguous(),
            rnd(3 * c, gpc, scale=0.05), rnd(gpc, scale=0.1, dtype=f32),
            rnd(gpc, c, scale=0.05), rnd(c, scale=0.1, dtype=f32),
            rnd(c, sec, scale=0.05), rnd(sec, scale=0.1, dtype=f32),
            rnd(sec, 2 * c, scale=0.05), rnd(2 * c, scale=0.1, dtype=f32))


def trunk(fn, x: torch.Tensor, blocks: list[tuple]) -> torch.Tensor:
    for wts in blocks:
        x = fn(x, *wts)
    return x


def block_ms(x: torch.Tensor, blocks: list[tuple], iters: int = 5,
             pool_boards: int | None = None) -> float:
    """ms per fused_gpbias_block call: `iters` trunks over `blocks` captured
    in one CUDA graph, divided by the calls."""
    fn = functools.partial(fused_gpbias_block, pool_boards=pool_boards)
    return graph_ms(lambda: trunk(fn, x, blocks), iters, (fused_gpbias_block,)) / len(blocks)


def block_kernels_ms(x: torch.Tensor, blocks: list[tuple], iters: int = 3,
                     pool_boards: int | None = None) -> tuple[dict[str, float], dict[str, int]]:
    """ms per launch of each of the block's kernels (BLOCK_KERNELS' names),
    each the mean over the launches of the last `iters` trunks over `blocks`
    in a trace (`trace_kernel_us`, `traced_kernel_ms`), their sum under
    "total", and how many launches of each the trace holds. Raises if it
    holds fewer of a kernel than `iters` trunks launch."""
    fn = functools.partial(fused_gpbias_block, pool_boards=pool_boards)
    trace = trace_kernel_us(lambda: trunk(fn, x, blocks), iters)
    traced = {name: traced_kernel_ms(trace, pattern, iters, len(blocks))
              for name, pattern in BLOCK_KERNELS}
    times = {name: ms for name, (ms, _) in traced.items()}
    return {**times, "total": sum(times.values())}, {name: n for name, (_, n) in traced.items()}


def pool_boards_ms(x: torch.Tensor, blocks: list[tuple]) -> dict[int, tuple[float, float]]:
    """The block with 1 and with 4 boards per CTA of its pool kernel:
    boards -> (ms per block call by block_ms, ms of K0 from a trace). Raises
    unless both give the same bits."""
    outs = [fused_gpbias_block(x, *blocks[0], pool_boards=p) for p in (1, 4)]
    if not torch.equal(*outs):
        raise AssertionError("the block's output depends on pool_boards")
    return {p: (block_ms(x, blocks, pool_boards=p),
                block_kernels_ms(x, blocks, pool_boards=p)[0]["K0_pool"]) for p in (1, 4)}


def conv_inputs(b: int, cin: int, cout: int, g: torch.Generator, dev) -> tuple:
    x = torch.randn(9, 9, b, cin, generator=g, device=dev).to(torch.bfloat16)
    w = (torch.randn(3, 3, cin, cout, generator=g, device=dev)
         / math.sqrt(9 * cin)).to(torch.bfloat16)
    return x, w


def stem_conv_ms(x: torch.Tensor, w: torch.Tensor) -> dict[str, float]:
    """The input conv's times for x (9, 9, B, Cin) and w (3, 3, Cin, Cout),
    Cin not a multiple of 64: "hwbc" conv3x3_hwbc(x, w), "padded" the same
    on tensors padded beforehand (the forward's call), "mma_sync" the
    one-board-per-CTA kernel, "cudnn" F.conv2d in bf16 channels_last, and
    "cudnn_padded" the same on the padded tensors. Outside the forward's
    call, on an f32 observation (B, Cin, 9, 9) of x's values: "fill" the
    forward's padded_planes (zeros, then a strided cast copy) and "cast" the
    one cast copy, obs.permute(2, 3, 0, 1).to(bf16), that unpadded planes
    would take."""
    xp, wp = pad_channels(x, 3), pad_channels(w, 2)
    x_cl, w_cl, xp_cl, wp_cl = cudnn_x(x), cudnn_w(w), cudnn_x(xp), cudnn_w(wp)
    obs = x.permute(2, 3, 0, 1).float().contiguous()
    if not torch.equal(padded_planes(obs, xp.shape[3]), xp):
        raise AssertionError("padded_planes differs from the zero-padded cast")
    return {"hwbc": graph_ms(lambda: conv3x3_hwbc(x, w)),
            "padded": graph_ms(lambda: conv3x3_hwbc(xp, wp)),
            "mma_sync": graph_ms(lambda: conv3x3_bpc(x, w, boards_per_cta=1)),
            "cudnn": graph_ms(lambda: F.conv2d(x_cl, w_cl, padding=1)),
            "cudnn_padded": graph_ms(lambda: F.conv2d(xp_cl, wp_cl, padding=1)),
            "fill": graph_ms(lambda: padded_planes(obs, xp.shape[3])),
            "cast": graph_ms(lambda: obs.permute(2, 3, 0, 1).to(torch.bfloat16))}


def forward_check(dev, batches=BATCHES) -> None:
    """The fused forward against the eager bf16 model, and both times."""
    torch.manual_seed(0)
    model, cfg = build_model("se_resnet", {"num_blocks": BLOCKS, "channels": C})
    model.to(dev).eval()
    fwd = make_fused_forward(cfg)
    weights = fwd.prepare(model)
    g = torch.Generator(device=dev).manual_seed(6)
    for b in batches:
        obs = (torch.rand(b, PLANES, 9, 9, generator=g, device=dev) > 0.8).float()
        with torch.no_grad():
            got, ref = fwd(weights, obs), model(obs)
            eager_ms = cuda_ms(lambda: model(obs), iters=5)
        fused_ms = cuda_ms(lambda: fwd(weights, obs), iters=5)
        err = float((got.policy_logits - ref.policy_logits).abs().max())
        agree = float((got.policy_logits.reshape(b, -1).argmax(1)
                       == ref.policy_logits.reshape(b, -1).argmax(1)).float().mean())
        print(f"forward B={b}: policy max abs err {err:.3f}, top-1 agreement {agree:.3f}; "
              f"eager {eager_ms:.3f} ms, fused {fused_ms:.3f} ms ({eager_ms / fused_ms:.2f}x)",
              flush=True)


def main(argv=None) -> int:
    if not torch.cuda.is_available():
        print("profile_fused_forward: no CUDA device", file=sys.stderr)
        return 2
    batches = tuple(int(a) for a in (sys.argv[1:] if argv is None else argv)) or BATCHES
    print(card())
    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    forward_check(dev, batches)
    g = torch.Generator(device=dev).manual_seed(0)
    for b in batches:
        t = stem_conv_ms(*conv_inputs(b, PLANES, C, g, dev))
        print(f"input conv B={b} {PLANES}->{C}: conv3x3_hwbc {t['hwbc']:.4f} ms (pads inside), "
              f"on padded planes {t['padded']:.4f}, mma.sync {t['mma_sync']:.4f}, "
              f"cuDNN {t['cudnn']:.4f} (on padded planes {t['cudnn_padded']:.4f}); outside "
              f"the conv, padded fill {t['fill']:.4f} against one cast copy {t['cast']:.4f}")
        xc, wc = conv_inputs(b, C, C, g, dev)
        print(f"conv3x3_hwbc B={b} {C}->{C}: {graph_ms(lambda: conv3x3_hwbc(xc, wc)):.4f} ms")
        del xc, wc
        blocks = [block_weights(C, GPC, SEC, g, dev) for _ in range(BLOCKS)]
        x = torch.relu(torch.randn(9, 9, b, C, generator=g, device=dev)).to(torch.bfloat16)
        ms = block_ms(x, blocks)
        parts, traced = block_kernels_ms(x, blocks)
        print(f"fused_gpbias_block B={b} C={C}: {ms:.4f} ms per call (graph of {BLOCKS}); "
              "trace: " + " ".join(f"{k}={v:.4f}" for k, v in parts.items())
              + f" (the trace holds {sorted(set(traced.values()))} launches of each)",
              flush=True)
        pool = pool_boards_ms(x, blocks)
        print(f"  pool kernel, boards per CTA (block_plan takes {block_plan(b, C).pool_boards}): "
              + "; ".join(f"{p}: block {t[0]:.4f} ms, K0 {t[1]:.4f}" for p, t in pool.items()),
              flush=True)
        del blocks, x
    return 0


if __name__ == "__main__":
    sys.exit(main())

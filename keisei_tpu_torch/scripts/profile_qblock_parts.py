"""Where the int8 block's time goes on the card: qblock.cu with parts
stripped, and a dependent-dot chain whose weight streams from L2
(counterpart of scripts/profile_qblock_parts.py, whose Pallas kernels
make_stripped and make_dotrate it replaces).

`qblock_part(variant, xq, wq1, wq2, batch_tile=...)` runs one stripped
variant (csrc/qblock_parts.cu, composed from the block's own kernels: the
s8 wgmma conv, the tile maxima, the requantize pass):

    convs     s8 conv1, h = max(acc * 1e-4, 0) and the tile max, the
              requantize pass, s8 conv2, clip(acc, +-127): the GEMMs, the
              scalar work of a requantize and the block's f32 round trip
    novpu     conv1, acc & 1, conv2, acc & 1: the int8 h crosses device
              memory (no CTA of the wgmma tiling holds a board)
    vpuonly   convs' three passes with each GEMM replaced by its input
    bf16gemm  novpu's structure on bf16 operands (the bf16 wgmma conv), x 1e-2
    gemmonly  both convs from x: (conv1(x) & 1, conv2(x) & 1)

`gemm3d` is gemmonly's function under another Mosaic lowering on the TPU; it
runs gemmonly here. `full` is the block itself (ops/qblock.py), each of its
six kernels timed from a torch.profiler (CUPTI) trace of block calls. int8
variants take weights as
quantize_conv_weights lays them out, (3, 3, Cout, Cin); bf16gemm takes bf16
(3, 3, Cin, Cout), as conv3x3_hwbc does.

Where this differs from the TPU script: its variants work on the banded
(145, B, 3C) layout and do not mask the 11x11 border (qblock.py masks it
before every nonlinearity; _convs_kernel does not), so in convs, novpu and
bf16gemm the border garbage of conv1 enters the tile amax and conv2's input
and their interior outputs are not a function of the 9x9 boards. The port
works on (9, 9, B, C) boards with a zero border: its variants compute the
masked function, the production rule. vpuonly, and gemmonly's conv1 half,
are the same function on both.

`dot_chain(x, w, chain)` is make_dotrate's function, X <- (X @ W) & 1 in int8
or X <- bf16((X @ W) * 1e-3) in bf16, with w given as W^T ([n][k]), at the
TPU script's (121*32, 768) @ (768, 768), on csrc/chain_wgmma.cu
(ops/gemm_chain.py): W (576 KB int8, 1.15 MB bf16) does not fit in one SM's
shared memory, so clusters of 4 CTAs split its output columns and hand each
other their columns of X after every product (int8 through distributed
shared memory, bf16 through L2); each CTA keeps its int8 W slice resident
and streams its bf16 one from L2 every step.

On CPU tensors both run their plain versions. `.launches` count calls per
variant (per type for dot_chain); `full` counts in
quantized_gpbias_block.launches, one per block (six kernels).

    python -m keisei_tpu_torch.scripts.profile_qblock_parts [B] [variants] [BT]
    python -m keisei_tpu_torch.scripts.profile_qblock_parts trunk [B ...]

B defaults to 1024, variants to full,convs,novpu,vpuonly,bf16gemm,gemmonly,
dotrate,dotrate16 (comma-separated), BT to 32. Prints the card's name and
power limit, then ms per call and T(FL)OP/s per variant (operations of the
81 board squares; the TPU script counted the 121 of its padded layout); the
dot chains also their CTAs, the bytes of W a launch reads from L2, and, as
context the port never calls, the same chain as 8 cuBLAS products
(`torch._int_mm` / `torch.matmul`) with their elementwise epilogues,
replayed from a CUDA graph.
`trunk` times the block itself as the int8 forward calls it, over 40
distinct weight sets (b40c256's trunk) at B = 64, 256, 1024 or the B given:
ms per call from one CUDA graph of 40-call trunks, and each kernel's from a
trace (copy this file into an older tree to time its block the same way).
Needs a CUDA device; exits non-zero without one.
"""

from __future__ import annotations

import math
import re
import sys
from collections import Counter

import torch

from ..ops import _build
from ..ops.conv3x3 import conv3x3_taps_f32, wgmma_tile
from ..ops.gemm_chain import ctas, gemm_chain, gemm_chain_reference, type_key, w_l2_bytes
from ..ops.qblock import (_qconv_taps, _qconv_taps_exact, _quantize_tiles, pack_quantized,
                          quantize_conv_weights, quantized_gpbias_block,
                          quantized_gpbias_block_reference)
from ..utils.timing import card, graph_ms, trace_kernel_us, traced_kernel_ms

VARIANTS = ("convs", "novpu", "vpuonly", "bf16gemm", "gemmonly")
ALIASES = {"gemm3d": "gemmonly"}
SUPPORTED_C = (128, 256)
B, CH, BT = 1024, 256, 32   # the TPU script's defaults: rollout batch, channels, tile
BLOCKS = 40                  # b40c256's trunk: the weight sets of `block`
TRUNK_BATCHES = (64, 256, 1024)
DOT_M, DOT_K, DOT_CHAIN = 121 * 32, 768, 8    # the TPU script's M = 121 * BT, K = 3C
# the block's six kernels (csrc/qblock.cu), by a pattern of the name the profiler reports
FULL_KERNELS = (("K0_pool", r"gp_pool_kernel"), ("K1_conv1", r"QConvH"),
                ("Q1_requant_h", r"requant_kernel<\d+,0>"), ("K2_conv2", r"QConvSums"),
                ("K3_se", r"qblock_se_kernel"), ("Q2_requant_y", r"requant_kernel<\d+,1>"))
# outputs that are exact integers (parity bits of exact sums); convs and
# vpuonly round through a tile quantization
EXACT = ("novpu", "gemmonly", "dotrate")


def _variant(variant: str) -> str:
    v = ALIASES.get(variant, variant)
    if v not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS + tuple(ALIASES)}, got {variant!r}")
    return v


def _check(variant: str, xq, wq1, wq2, batch_tile: int) -> None:
    dtype = torch.bfloat16 if variant == "bf16gemm" else torch.int8
    if xq.dim() != 4 or tuple(xq.shape[:2]) != (9, 9):
        raise ValueError(f"expected xq (9, 9, B, C), got {tuple(xq.shape)}")
    n, c = xq.shape[2], xq.shape[3]
    if batch_tile < 1 or n % batch_tile:
        raise ValueError(f"B={n} not divisible by batch_tile={batch_tile}")
    for name, t in (("xq", xq), ("wq1", wq1), ("wq2", wq2)):
        if t.dtype != dtype:
            raise TypeError(f"{variant}: {name} must be {dtype}, got {t.dtype}")
        if t.device != xq.device:
            raise ValueError(f"{name} on {t.device} but xq on {xq.device}")
    for name, t in (("wq1", wq1), ("wq2", wq2)):
        if tuple(t.shape) != (3, 3, c, c):
            raise ValueError(f"{name}: expected shape {(3, 3, c, c)}, got {tuple(t.shape)}")


def qblock_part_reference(variant: str, xq, wq1, wq2, *, batch_tile: int = 32) -> torch.Tensor:
    """Plain version of a stripped variant on zero-bordered boards: exact
    integer convs (rounded to f32 where the kernel converts its int32 sums),
    the block's tile quantizer."""
    variant = _variant(variant)
    _check(variant, xq, wq1, wq2, batch_tile)
    n, ch = xq.shape[2], xq.shape[3]
    shape = (9, 9, n, ch)
    if variant == "bf16gemm":
        h = (conv3x3_taps_f32(xq, wq1) * 1e-2).to(torch.bfloat16)
        return (conv3x3_taps_f32(h, wq2) * 1e-2).to(torch.bfloat16)
    if variant in ("convs", "vpuonly"):
        acc1 = xq.reshape(81, n, ch).float() if variant == "vpuonly" else _qconv_taps(xq, wq1)
        hq, _ = _quantize_tiles(torch.relu(acc1 * 1e-4), batch_tile)
        acc2 = hq.float() if variant == "vpuonly" else _qconv_taps(hq.reshape(shape), wq2)
        return torch.clamp(acc2, -127, 127).to(torch.int8).reshape(shape)

    def parity(q, w):
        return torch.bitwise_and(_qconv_taps_exact(q, w).long(), 1).to(torch.int8).reshape(shape)

    hq = parity(xq, wq1)
    if variant == "novpu":
        return parity(hq, wq2)
    return torch.stack([hq, parity(xq, wq2)])  # gemmonly


def qblock_part(variant: str, xq, wq1, wq2, *, batch_tile: int = 32) -> torch.Tensor:
    """One stripped variant of the int8 block: xq (9, 9, B, C) -> (9, 9, B, C)
    int8 (bf16 for bf16gemm; (2, 9, 9, B, C) for gemmonly)."""
    variant = _variant(variant)
    _check(variant, xq, wq1, wq2, batch_tile)
    if xq.device.type == "cpu":
        return qblock_part_reference(variant, xq, wq1, wq2, batch_tile=batch_tile)
    if xq.device.type != "cuda":
        raise ValueError(f"unsupported device {xq.device}")
    n, ch = xq.shape[2], xq.shape[3]
    if ch not in SUPPORTED_C:
        raise ValueError(f"CUDA qblock_part takes C in {SUPPORTED_C}, got {ch}")
    if batch_tile % 16:
        raise ValueError(f"CUDA qblock_part takes batch_tile a multiple of 16, got {batch_tile}")
    if not all(t.is_contiguous() for t in (xq, wq1, wq2)):
        raise ValueError("xq, wq1 and wq2 must be contiguous")
    lib = _build.load_library()
    out = torch.empty(((2,) if variant == "gemmonly" else ()) + tuple(xq.shape),
                      dtype=xq.dtype, device=xq.device)

    def scratch(needed: bool, dtype, shape=xq.shape):
        return torch.empty(shape, dtype=dtype, device=xq.device) if needed else None

    quantizes = variant in ("convs", "vpuonly")
    act = scratch(quantizes or variant == "bf16gemm",
                  torch.bfloat16 if variant == "bf16gemm" else torch.float32)
    hq = scratch(quantizes or variant == "novpu", torch.int8)
    words = scratch(quantizes, torch.int32, (n // batch_tile,))
    stream = torch.cuda.current_stream(xq.device).cuda_stream
    err = lib.keisei_qblock_part(VARIANTS.index(variant), xq.data_ptr(), wq1.data_ptr(),
                                 wq2.data_ptr(), out.data_ptr(),
                                 *[None if t is None else t.data_ptr() for t in (act, hq, words)],
                                 n, ch, batch_tile, wgmma_tile(n, ch).boards, stream)
    _build.check(lib, err, f"qblock_part({variant}) launch")
    qblock_part.launches[variant] += 1
    return out


qblock_part.launches = Counter()


def _check_dot(x, w, chain: int) -> None:
    if x.dtype not in (torch.int8, torch.bfloat16) or w.dtype != x.dtype:
        raise TypeError(f"x and w must both be int8 or bfloat16, got {x.dtype} and {w.dtype}")
    if x.dim() != 2 or x.shape[1] != DOT_K or tuple(w.shape) != (DOT_K, DOT_K):
        raise ValueError(f"expected x (M, {DOT_K}) and w ({DOT_K}, {DOT_K}), "
                         f"got {tuple(x.shape)} and {tuple(w.shape)}")
    if w.device != x.device:
        raise ValueError(f"w on {w.device} but x on {x.device}")
    if chain < 1:
        raise ValueError(f"chain must be >= 1, got {chain}")


def dot_chain_reference(x, w, chain: int) -> torch.Tensor:
    """Plain version: int8 X <- (X @ w^T) & 1 in exact f64; bf16 X <-
    bf16(f32(X @ w^T) * 1e-3)."""
    _check_dot(x, w, chain)
    return gemm_chain_reference(x, w, chain)


def dot_chain(x, w, chain: int) -> torch.Tensor:
    """x (M, 768), w (768, 768) [n][k] (W^T), both int8 or both bf16 ->
    X_chain of X_0 = x, X_{i+1} = (X_i @ w^T) & 1 (int8) or
    bf16((X_i @ w^T) * 1e-3) (bf16)."""
    _check_dot(x, w, chain)
    out = gemm_chain(x, w, chain)
    if x.device.type == "cuda":
        dot_chain.launches[type_key(x.dtype)] += 1
    return out


dot_chain.launches = Counter()


def cublas_chain(x, w, chain: int) -> torch.Tensor:
    """The same chain as `chain` cuBLAS products with their epilogues as
    separate elementwise kernels: `torch._int_mm` and & 1 in int8;
    `torch.matmul` (bf16 out: its f32 sums rounded once more than the
    kernel's) then * 1e-3 in bf16. Context for the kernel's time: the rate
    cuBLAS reaches at this shape. The port never calls it."""
    wt = w.t()
    for _ in range(chain):
        if x.dtype == torch.int8:
            x = torch.bitwise_and(torch._int_mm(x, wt), 1).to(torch.int8)
        else:
            x = (torch.matmul(x, wt).float() * 1e-3).to(torch.bfloat16)
    return x


def part_inputs(variant: str, b: int, c: int, device, seed: int = 0):
    """(xq, wq1, wq2) for a variant, made from `seed`: int8 values in
    [-127, 127]; for bf16gemm bf16 normals, the weights scaled by
    100 / sqrt(9C) so that each conv * 1e-2 stays of order one."""
    g = torch.Generator().manual_seed(seed)
    if _variant(variant) == "bf16gemm":
        x = torch.randn(9, 9, b, c, generator=g)
        ws = [torch.randn(3, 3, c, c, generator=g) * (100 / math.sqrt(9 * c)) for _ in range(2)]
        return tuple(t.to(torch.bfloat16).to(device) for t in (x, *ws))
    return tuple(torch.randint(-127, 128, shape, generator=g, dtype=torch.int8).to(device)
                 for shape in ((9, 9, b, c), (3, 3, c, c), (3, 3, c, c)))


def dot_inputs(dtype: torch.dtype, m: int, device, seed: int = 0):
    """x (m, 768), w (768, 768): int8 x in {0, 1} and w in {-1, 0, 1}; bf16
    normals with w scaled so that |X| stays of order one along the chain."""
    g = torch.Generator().manual_seed(seed)
    if dtype == torch.int8:
        x = torch.randint(0, 2, (m, DOT_K), generator=g)
        w = torch.randint(-1, 2, (DOT_K, DOT_K), generator=g)
    else:
        x = torch.randn(m, DOT_K, generator=g)
        w = torch.randn(DOT_K, DOT_K, generator=g) * (1e3 / math.sqrt(DOT_K))
    return x.to(dtype).to(device), w.to(dtype).to(device)


def full_block_args(b: int, c: int, bt: int, device, seed: int = 0) -> tuple:
    """The int8 block's operands at (b, c) as the TPU script's make_full
    builds them (conv weights quantized from normals x 0.05, bn_affine ones,
    FC weights 0.01, gpc 64, se 16), with a normal input packed by tile."""
    g = torch.Generator().manual_seed(seed)
    xq, sx = pack_quantized(torch.randn(9, 9, b, c, generator=g), bt)
    wq, _ = quantize_conv_weights(torch.randn(3, 3, c, c, generator=g) * 0.05)
    gpc, sec = 64, 16
    bf = torch.bfloat16
    args = (xq, sx, wq, wq, torch.ones(4, c),
            torch.full((3 * c, gpc), 0.01, dtype=bf), torch.zeros(gpc),
            torch.full((gpc, c), 0.01, dtype=bf), torch.zeros(c),
            torch.full((c, sec), 0.01, dtype=bf), torch.zeros(sec),
            torch.full((sec, 2 * c), 0.01, dtype=bf), torch.zeros(2 * c))
    return tuple(t.to(device).contiguous() for t in args)


def int8_weights(w1, w2, bn, *fcs) -> tuple:
    """A bf16 block's weights (profile_fused_forward.block_weights) as the
    int8 forward's prepare quantizes them: (wq1, wq2, bn_affine, *fcs)."""
    wq1, ws1 = quantize_conv_weights(w1)
    wq2, ws2 = quantize_conv_weights(w2)
    return (wq1, wq2, torch.stack([bn[0] * ws1, bn[1], bn[2] * ws2, bn[3]]).contiguous(), *fcs)


def trunk(fn, xq, sx, blocks: list[tuple], bt: int = BT):
    """xq, sx through one block call per weight set of `blocks`."""
    for wts in blocks:
        xq, sx = fn(xq, sx, *wts, batch_tile=bt)
    return xq, sx


def block_ms(xq, sx, blocks: list[tuple], bt: int = BT, iters: int = 5) -> float:
    """ms per quantized_gpbias_block call: `iters` trunks over `blocks`
    captured in one CUDA graph, divided by the calls."""
    return graph_ms(lambda: trunk(quantized_gpbias_block, xq, sx, blocks, bt), iters,
                    (quantized_gpbias_block,)) / len(blocks)


def block_kernels_ms(xq, sx, blocks: list[tuple], bt: int = BT,
                     iters: int = 3) -> tuple[dict[str, float], dict[str, int]]:
    """ms per launch of each of the block's six kernels (FULL_KERNELS'
    names) and their sum under "total", each the mean over the launches of
    the last `iters` trunks over `blocks` in a torch.profiler (CUPTI) trace
    (`trace_kernel_us`, `traced_kernel_ms`), and how many launches of each
    the trace holds. Raises if it holds fewer of a kernel than `iters`
    trunks launch."""
    trace = trace_kernel_us(lambda: trunk(quantized_gpbias_block, xq, sx, blocks, bt), iters)
    traced = {name: traced_kernel_ms(trace, pattern, iters, len(blocks))
              for name, pattern in FULL_KERNELS}
    times = {name: ms for name, (ms, _) in traced.items()}
    return {**times, "total": sum(times.values())}, {name: n for name, (_, n) in traced.items()}


def full_kernel_ms(args: tuple, bt: int,
                   iters: int = 20) -> tuple[dict[str, float], dict[str, int]]:
    """block_kernels_ms of the block on args (xq, sx, *weights): the mean
    over its last `iters` calls."""
    xq, sx, *wts = args
    return block_kernels_ms(xq, sx, [tuple(wts)], bt, iters)


def trunk_inputs(b: int, device, seed: int = 0, c: int = CH, gpc: int = 128, sec: int = 16):
    """xq, sx of a relu(normal) input and `BLOCKS` int8 weight sets made
    from b40c256's block weights (profile_fused_forward.block_weights, gp
    128, SE 16), from `seed`: the int8 trunk at batch b."""
    from .profile_fused_forward import block_weights
    g = torch.Generator(device=device).manual_seed(seed)
    blocks = [int8_weights(*block_weights(c, gpc, sec, g, device)) for _ in range(BLOCKS)]
    x = torch.relu(torch.randn(9, 9, b, c, generator=g, device=device))
    return (*pack_quantized(x, BT), blocks)


def conv_ops(b: int, c: int) -> float:
    """Operations of one 3x3 conv over b boards (81 squares), c -> c."""
    return 2.0 * 81 * b * 9 * c * c


def measure(device, b: int = B, bt: int = BT,
            names: tuple[str, ...] = ("full", *VARIANTS, "dotrate", "dotrate16"),
            iters: int = 20) -> dict:
    """ms per call of each named variant at (b, 256), replayed from a CUDA
    graph (`full`: the sum of its six kernels' ms, which it adds): its
    operations and rate; dotrate* the CTA count, the W bytes a launch reads
    from L2 and the cuBLAS chain's ms (cublas_chain, from a graph)."""
    results = {}
    for name in names:
        if name in ("dotrate", "dotrate16"):
            dtype = torch.int8 if name == "dotrate" else torch.bfloat16
            x, w = dot_inputs(dtype, DOT_M, device, seed=1)
            ms = graph_ms(lambda: dot_chain(x, w, DOT_CHAIN), iters, (dot_chain.launches,))
            ops = 2.0 * DOT_M * DOT_K * DOT_K * DOT_CHAIN
            results[name] = {"ms": ms, "ops": ops, "ctas": ctas(DOT_M, dtype, DOT_K),
                             "w_l2_bytes": w_l2_bytes(DOT_M, dtype, DOT_K, DOT_CHAIN),
                             "cublas_ms": graph_ms(lambda: cublas_chain(x, w, DOT_CHAIN), iters)}
        elif name == "full":
            parts, traced = full_kernel_ms(full_block_args(b, CH, bt, device), bt, iters)
            results[name] = {"ms": parts["total"], "ops": 2 * conv_ops(b, CH), "kernels": parts,
                             "traced": traced}
        else:
            v = _variant(name)
            xq, w1, w2 = part_inputs(v, b, CH, device, seed=1)
            ms = graph_ms(lambda: qblock_part(v, xq, w1, w2, batch_tile=bt), iters,
                          (qblock_part.launches,))
            results[name] = {"ms": ms, "ops": 0.0 if v == "vpuonly" else 2 * conv_ops(b, CH)}
        results[name]["rate"] = results[name]["ops"] / (results[name]["ms"] * 1e-3)
    return results


def check(device, b: int = 64, c: int = 256, bt: int = 32) -> dict[str, dict]:
    """Every variant and both dot chains against their plain versions on a
    small input, by compare_to_plain. Raises on a disagreement; returns the
    errors."""
    errs = {}
    for v in VARIANTS:
        args = part_inputs(v, b, c, device)
        got, ref = qblock_part(v, *args, batch_tile=bt), qblock_part_reference(v, *args,
                                                                               batch_tile=bt)
        errs[v] = compare_to_plain(v, got, ref)
    for dtype, name in ((torch.int8, "dotrate"), (torch.bfloat16, "dotrate16")):
        x, w = dot_inputs(dtype, 200, device)
        errs[name] = compare_to_plain(name, dot_chain(x, w, 3), dot_chain_reference(x, w, 3))
    return errs


def compare_to_plain(name: str, got: torch.Tensor, ref: torch.Tensor) -> dict:
    """The bound for output `name` (a variant or dotrate*): equal for the
    EXACT ones; bf16 within rtol = atol = 0.05; convs and vpuonly at most 1
    level apart and >= 99% identical. Raises outside it."""
    diff = (got.float() - ref.float()).abs()
    if name in EXACT:
        ok = torch.equal(got, ref)
        res = {"max_abs_err": float(diff.max())}
    elif got.dtype == torch.bfloat16:
        ok = torch.allclose(got.float(), ref.float(), rtol=0.05, atol=0.05)
        res = {"max_abs_err": float(diff.max())}
    else:
        res = {"max_abs_err": float(diff.max()), "identical": float((diff == 0).float().mean())}
        ok = res["max_abs_err"] <= 1 and res["identical"] >= 0.99
    if not ok:
        raise AssertionError(f"{name} disagrees with its plain version: {res}")
    return res


def trunk_measure(device, b: int) -> str:
    """The block in b40c256's trunk at batch b: the first weight set against
    the plain version (the card-test bound), ms per call from a CUDA graph of
    40-call trunks, and each kernel's ms from a trace; a line to print. A
    trace of another tree's block (timed beside this one) whose kernels
    FULL_KERNELS does not name is reported per kernel name."""
    xq, sx, blocks = trunk_inputs(b, device)
    (yq, sy), (rq, rs) = (quantized_gpbias_block(xq, sx, *blocks[0], batch_tile=BT),
                          quantized_gpbias_block_reference(xq, sx, *blocks[0], batch_tile=BT))
    diff = (yq.int() - rq.int()).abs()
    if not (int(diff.max()) <= 1 and float((diff == 0).float().mean()) >= 0.99
            and float(((sy - rs).abs() / rs).max()) <= 1e-4):
        raise AssertionError(f"int8 block B={b} disagrees with its plain version")
    ms = block_ms(xq, sx, blocks)
    trace = trace_kernel_us(lambda: trunk(quantized_gpbias_block, xq, sx, blocks), 3)
    names = [n.replace(" ", "") for n in trace]
    if all(any(re.search(p, n) for n in names) for _, p in FULL_KERNELS):
        parts, _ = block_kernels_ms(xq, sx, blocks)
    else:
        parts = {n.split("(")[0][-60:]: sum(us) / len(us) / 1e3 for n, us in trace.items()}
    return (f"quantized_gpbias_block B={b} C={CH} bt={BT} weight_sets={BLOCKS}: {ms:.4f} ms per "
            "call (graph); trace: " + " ".join(f"{k}={v:.4f}" for k, v in parts.items()))


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("profile_qblock_parts: no CUDA device", file=sys.stderr)
        return 2
    if len(argv) > 1 and argv[1] == "trunk":
        print(card())
        for b in (tuple(int(a) for a in argv[2:]) or TRUNK_BATCHES):
            print(trunk_measure(torch.device("cuda"), b), flush=True)
        return 0
    b = int(argv[1]) if len(argv) > 1 else B
    names = tuple(argv[2].split(",")) if len(argv) > 2 else ("full", *VARIANTS, "dotrate",
                                                             "dotrate16")
    bt = int(argv[3]) if len(argv) > 3 else BT
    print(card())
    dev = torch.device("cuda")
    check(dev)
    for name, r in measure(dev, b, bt, names).items():
        line = f"{name:9s}: {r['ms']:8.4f} ms  ({r['rate'] / 1e12:6.1f} T(FL)OP/s"
        if "ctas" in r:
            line += (f", M={DOT_M} chain={DOT_CHAIN}, {r['ctas']} CTAs on 132 SMs, "
                     f"W from L2 {r['w_l2_bytes'] / 1e6:.1f} MB; cuBLAS chain "
                     f"{r['cublas_ms']:.4f} ms)")
        else:
            line += f", B={b} C={CH} bt={bt})"
        if "kernels" in r:
            line += "  " + " ".join(f"{k}={r['kernels'][k]:.4f}" for k, _ in FULL_KERNELS)
            line += f"  (the trace holds {sorted(set(r['traced'].values()))} launches of each)"
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))

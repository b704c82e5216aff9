"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Imports no JAX, so it runs on a machine with a GPU and no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Without a card every test skips (the decision is made inside the fixture).
Tolerance: rtol = atol = 0.05 in bf16, as TestPallasConv holds the TPU
kernel to an XLA conv; both sides accumulate in f32 and round to bf16 at the
same points, so they differ only by summation order and one-ulp roundings.
The int8 block (six kernels per call) is held over B in {32, 64, 96, 256,
1024} x C in {128, 256}: its convs are exact on both sides, so its outputs
may differ only where an f32 sum taken in another order (pool, FCs, SE
mean) moves a value across a rounding boundary: at most 1 level apart,
>= 99% identical, scales within rtol 1e-4 (the same bound as the CPU test
against JAX). Its tile maxima do not depend on order, so a repeat gives the
same bits, and a CUDA graph replay on new values the new block. The
tensor-core probe (the gemm chain of csrc/chain_wgmma.cu, also the dot
chain's kernel) is exact in int8 and at the bf16 bound in bf16, at K = 512
and 768, chains of 1, 2, 8 and 32, an M that ends in a partial tile and one
of a single cluster; a bf16 chain longer than 8 is held step by step
(ops/gemm_chain.py:hold_to_plain: over 32 steps of a map that keeps |X| of
order one, two summation orders drift past the bound in a few elements
while each step stays within it). It sums in a fixed order, so a repeat
and a CUDA-graph replay give equal bits.

The wgmma conv (Cin % 64 == 0) is held to the same bound over tails in B
and every K depth, to max |err| / max |ref| < 0.02 as the probe script holds
it, and on one-hot boards (tests/test_torch_wgmma.py's inputs) to equality;
its tensor maps are kernel arguments, so it must also be right when replayed
from a CUDA graph on new input values. Any other Cin (the 50 observation
planes) takes the same kernel after a zero pad to 64 channels, at the same
bound.

The fused block (four kernels per call) is held to the bf16 bound over
B in {1, 31, 64, 65, 256, 1024} x C in {128, 256}; it sums in a fixed order
with no atomics, so a repeat must give equal bits, and like the conv it must
be right when replayed from a CUDA graph on new values.

The probes' kernels: the boards-per-CTA conv at the bf16 bound above; the
fused block's stage kernels within 1e-4 of max |ref| for the f32 stages
before any bf16 rounding (conv1, bnrelu, pool) and at rtol = atol = 0.05
after one (gpbias, conv2); the stripped int8 block's novpu and gemmonly
equal (parity bits of exact integer sums), convs and vpuonly (which round
through a tile quantization) at most 1 level apart and >= 99% identical,
bf16gemm at the bf16 bound; the
dot chain exact in int8 and at the bf16 bound in bf16; tiled_mm exact in
int8 and within 1e-4 of max |ref| in bf16 (f32 output).

The train path's kernels (ops/train_bn.py: BatchNorm's sums and apply, the
global pool, the block's two epilogues, forward and backward) are held to
their plain versions at B in {1, 1024, 2048} x C in {32, 128, 256} in f32 and
bf16; a b10c128-sized float32 model's three PPO minibatches on them to the
plain path's within 1e-2 (losses; the first minibatch's gradient: the
float32 twin, ROADMAP C item 9), and under
synced_batch_stats with a stand-in reduce within 1e-4.

The rules engine on the card gives the CPU engine's legal masks over 200
random plies at N=1024, with TF32 matmuls on and under bf16 autocast: its
table matmuls (the ray prefix among them) sum small integers, exact in both.
"""

import contextlib
from collections import Counter

import pytest
import torch

from keisei_tpu_torch.ops import _build
from keisei_tpu_torch.ops import conv3x3 as conv_ops
from keisei_tpu_torch.ops.conv3x3 import (WGMMA_BOARDS, ConvRoute, conv3x3_bpc, conv3x3_hwbc,
                                          conv3x3_hwbc_reference, conv_route)
from keisei_tpu_torch.ops.fused_block import (STAGES, block_plan, fused_block_stage,
                                              fused_block_stage_reference, fused_gpbias_block,
                                              fused_gpbias_block_reference)
from keisei_tpu_torch.ops.qblock import (pack_quantized, quantize_conv_weights,
                                         quantized_gpbias_block, quantized_gpbias_block_reference)
from keisei_tpu_torch.scripts import profile_direct_conv as direct
from keisei_tpu_torch.scripts import profile_fused_forward as fused_profile
from keisei_tpu_torch.scripts import profile_qblock_parts as qparts
from keisei_tpu_torch.scripts.debug_fused_block import EXACT_STAGES, stage_inputs
from keisei_tpu_torch.scripts.profile_conv_alternatives import (mm_inputs, tiled_mm,
                                                                tiled_mm_reference)
from keisei_tpu_torch.ops.gemm_chain import chain_plan, hold_to_plain
from keisei_tpu_torch.scripts.profile_int8_mma import mma_chain, probe_inputs
from keisei_tpu_torch.scripts import profile_train_bn as train_bn_probe
from keisei_tpu_torch.utils.timing import TRACE_LEAD, graph_ms

pytestmark = pytest.mark.cuda

TOL = 0.05


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.load_library()
    return torch.device("cuda")


def block_args(b, c, gpc, sec, dev, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)

    def rnd(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=g) * scale).to(dtype).to(dev)

    x = torch.relu(rnd(9, 9, b, c, dtype=torch.float32)).to(torch.bfloat16)
    s = 1.0 / (3 * c) ** 0.5
    bn = torch.stack([1 + 0.1 * torch.randn(c, generator=g), 0.1 * torch.randn(c, generator=g),
                      1 + 0.1 * torch.randn(c, generator=g), 0.1 * torch.randn(c, generator=g)])
    return (x, rnd(3, 3, c, c, scale=s), rnd(3, 3, c, c, scale=s), bn.float().to(dev),
            rnd(3 * c, gpc, scale=0.05), rnd(gpc, scale=0.1, dtype=torch.float32),
            rnd(gpc, c, scale=0.05), rnd(c, scale=0.1, dtype=torch.float32),
            rnd(c, sec, scale=0.05), rnd(sec, scale=0.1, dtype=torch.float32),
            rnd(sec, 2 * c, scale=0.05), rnd(2 * c, scale=0.1, dtype=torch.float32))


@pytest.mark.parametrize("b,cin,cout", [(64, 50, 256), (64, 256, 256), (3, 128, 128)])
def test_conv3x3_matches_plain(dev, b, cin, cout):
    g = torch.Generator(device="cpu").manual_seed(cin)
    x = torch.randn(9, 9, b, cin, generator=g).to(torch.bfloat16).to(dev)
    w = (torch.randn(3, 3, cin, cout, generator=g) / (9 * cin) ** 0.5).to(torch.bfloat16).to(dev)
    before = conv3x3_hwbc.launches
    got = conv3x3_hwbc(x, w)
    torch.cuda.synchronize()
    assert conv3x3_hwbc.launches == before + 1
    ref = conv3x3_hwbc_reference(x, w)
    torch.testing.assert_close(got.float(), ref.float(), rtol=TOL, atol=TOL)


def conv_inputs(b, cin, cout, dev, seed):
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn(9, 9, b, cin, generator=g).to(torch.bfloat16).to(dev)
    w = (torch.randn(3, 3, cin, cout, generator=g) / (9 * cin) ** 0.5).to(torch.bfloat16).to(dev)
    return x, w


@pytest.mark.parametrize("cout", [128, 256])
@pytest.mark.parametrize("cin", [64, 128, 256])
@pytest.mark.parametrize("b", [1, 7, 64, 65, 200, 256])
def test_conv3x3_wgmma_route_matches_plain(dev, b, cin, cout):
    x, w = conv_inputs(b, cin, cout, dev, seed=b + cin + cout)
    assert conv_route(b, cin, cout).kernel == "wgmma"
    before = Counter(conv3x3_hwbc.route_launches)
    got = conv3x3_hwbc(x, w)
    torch.cuda.synchronize()
    assert Counter(conv3x3_hwbc.route_launches) - before == Counter({"wgmma": 1})
    ref = conv3x3_hwbc_reference(x, w)
    torch.testing.assert_close(got.float(), ref.float(), rtol=TOL, atol=TOL)
    assert direct.compare_conv(0, got, ref) < 0.02


@pytest.mark.parametrize("cin,cout", [(50, 256), (46, 128), (100, 256)])
@pytest.mark.parametrize("b", [1, 65, 1024])
def test_conv3x3_padded_route_matches_plain(dev, b, cin, cout):
    """Cin % 64 != 0: zero channels up to 64s, then the wgmma kernel; never
    the mma.sync kernel."""
    x, w = conv_inputs(b, cin, cout, dev, seed=b + cin)
    before = Counter(conv3x3_hwbc.route_launches)
    got = conv3x3_hwbc(x, w)
    torch.cuda.synchronize()
    assert Counter(conv3x3_hwbc.route_launches) - before == Counter({"wgmma_padded": 1})
    ref = conv3x3_hwbc_reference(x, w)
    torch.testing.assert_close(got.float(), ref.float(), rtol=TOL, atol=TOL)
    assert direct.compare_conv(0, got, ref) < 0.02


@pytest.mark.parametrize("cin,cout", [(64, 128), (256, 256)])
@pytest.mark.parametrize("name", list(direct.ONE_HOT_SQUARES))
def test_conv3x3_wgmma_one_hot_taps(dev, name, cin, cout):
    """A transposed tap or a wrong zero-filled edge shows as a wrong square."""
    square = direct.ONE_HOT_SQUARES[name]
    for channel in (0, cin - 1):
        x, w = direct.one_hot_inputs(square, cin=cin, cout=cout, channel=channel)
        want = direct.one_hot_expected(square, w, 5, 2, channel)
        assert torch.equal(conv3x3_hwbc(x.to(dev), w.to(dev)).float().cpu(), want)
        for boards in WGMMA_BOARDS:
            got = conv3x3_bpc(x.to(dev), w.to(dev), boards_per_cta=boards)
            assert torch.equal(got.float().cpu(), want)


@pytest.mark.parametrize("boards,cout_tile", direct.WGMMA_TILES)
@pytest.mark.parametrize("persistent", [False, True])
def test_conv3x3_wgmma_every_tile_matches_plain(dev, boards, cout_tile, persistent):
    for b in (5, 130):
        x, w = conv_inputs(b, 128, 256, dev, seed=b + boards)
        got = conv_ops._conv_wgmma(x, w, ConvRoute("wgmma", boards, cout_tile, persistent))
        torch.cuda.synchronize()
        torch.testing.assert_close(got.float(), conv3x3_hwbc_reference(x, w).float(), rtol=TOL,
                                   atol=TOL)


def test_conv3x3_wgmma_replays_from_a_graph(dev):
    """The tensor maps are kernel arguments: a captured launch, replayed
    after the input's values changed in place, computes the new conv."""
    x, w = conv_inputs(65, 256, 256, dev, seed=11)
    conv3x3_hwbc(x, w)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        out = conv3x3_hwbc(x, w)
    x.copy_(conv_inputs(65, 256, 256, dev, seed=12)[0])
    graph.replay()
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), conv3x3_hwbc_reference(x, w).float(), rtol=TOL,
                               atol=TOL)
    assert graph_ms(lambda: conv3x3_hwbc(x, w), iters=5) > 0


def test_conv3x3_wgmma_raises_and_never_falls_back(dev):
    """What the wgmma kernel does not take raises, in the wrapper or from
    the C entry point; no launch is counted and nothing else runs."""
    x, w = conv_inputs(4, 64, 384, dev, seed=1)
    before = conv3x3_hwbc.launches, dict(conv3x3_bpc.launches)
    with pytest.raises(ValueError, match="Cout"):
        conv_ops._conv_wgmma(x, w, ConvRoute("wgmma", 64, 256, True))
    with pytest.raises(RuntimeError, match="CUDA error"):
        conv_ops._conv_wgmma(x, w, ConvRoute("wgmma", 32, 128, True))
    x50, w50 = conv_inputs(4, 50, 256, dev, seed=2)
    with pytest.raises(ValueError, match="Cin % 64"):
        conv3x3_bpc(x50, w50, boards_per_cta=64)
    assert (conv3x3_hwbc.launches, dict(conv3x3_bpc.launches)) == before


@pytest.mark.parametrize("b,c,gpc,sec", [(64, 256, 128, 16), (5, 128, 64, 8),
                                         # FC widths off the 16-byte weight loads
                                         (7, 128, 12, 4), (3, 256, 100, 18)])
def test_fused_block_matches_plain(dev, b, c, gpc, sec):
    args = block_args(b, c, gpc, sec, dev)
    before = fused_gpbias_block.launches
    got = fused_gpbias_block(*args)
    torch.cuda.synchronize()
    assert fused_gpbias_block.launches == before + 1
    ref = fused_gpbias_block_reference(*args)
    torch.testing.assert_close(got.float(), ref.float(), rtol=TOL, atol=TOL)


BLOCK_GRID = [(b, c) for b in (1, 31, 64, 65, 256, 1024) for c in (128, 256)]


@pytest.mark.parametrize("b,c", BLOCK_GRID)
def test_fused_block_grid_matches_plain_with_equal_bits(dev, b, c):
    """Partial tiles in B on both tile heights, both widths; a second run
    gives the same bits (fixed summation order, no atomics)."""
    args = block_args(b, c, c // 2, c // 16, dev, seed=b + c)
    assert block_plan(b, c).tile.boards == (128 if b > (512 if c == 256 else 128) else 64)
    before = fused_gpbias_block.launches
    got = fused_gpbias_block(*args)
    again = fused_gpbias_block(*args)
    torch.cuda.synchronize()
    assert fused_gpbias_block.launches == before + 2
    assert torch.equal(got, again)
    ref = fused_gpbias_block_reference(*args)
    torch.testing.assert_close(got.float(), ref.float(), rtol=TOL, atol=TOL)


def test_fused_block_replays_from_a_graph(dev):
    """Tensor maps and scratch pointers are captured; replayed after x's
    values changed in place, the graph computes the new block."""
    args = block_args(65, 256, 128, 16, dev, seed=3)
    fused_gpbias_block(*args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        out = fused_gpbias_block(*args)
    args[0].copy_(block_args(65, 256, 128, 16, dev, seed=4)[0])
    graph.replay()
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), fused_gpbias_block_reference(*args).float(),
                               rtol=TOL, atol=TOL)


def test_fused_block_raises_and_never_falls_back(dev):
    """C = 192 and non-contiguous operands raise; no launch is counted."""
    before = fused_gpbias_block.launches, dict(fused_block_stage.launches)
    args = block_args(4, 192, 96, 12, dev)
    with pytest.raises(ValueError, match="C in"):
        fused_gpbias_block(*args)
    with pytest.raises(ValueError, match="C in"):
        fused_block_stage(*args[:8], stage="conv2")
    x, *rest = block_args(4, 128, 64, 8, dev)
    strided = torch.cat([x, x], dim=3)[..., :128]
    with pytest.raises(ValueError, match="contiguous"):
        fused_gpbias_block(strided, *rest)
    w1t = rest[0].transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        fused_gpbias_block(x, w1t, *rest[1:])
    with pytest.raises(ValueError, match="contiguous"):
        fused_block_stage(strided, *rest[:7], stage="pool")
    assert (fused_gpbias_block.launches, dict(fused_block_stage.launches)) == before


def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    x = torch.zeros(9, 9, 2, 32, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="Cout"):
        conv3x3_hwbc(x, torch.zeros(3, 3, 32, 32, dtype=torch.bfloat16, device=dev))
    with pytest.raises(TypeError):
        conv3x3_hwbc(x.float(), torch.zeros(3, 3, 32, 128, device=dev))


def qblock_args(b, c, gpc, sec, dev, bt=32, seed=0):
    """The int8 block's operands, quantized from block_args' float ones."""
    x, w1, w2, bn, *fcs = block_args(b, c, gpc, sec, dev, seed)
    xq, sx = pack_quantized(x.float(), bt)
    wq1, ws1 = quantize_conv_weights(w1.float())
    wq2, ws2 = quantize_conv_weights(w2.float())
    m = torch.stack([bn[0] * ws1, bn[1], bn[2] * ws2, bn[3]]).contiguous()
    return (xq, sx, wq1, wq2, m, *fcs)


def assert_int8_close(got, ref):
    (yq, sy), (rq, rs) = got, ref
    diff = (yq.int() - rq.int()).abs()
    assert int(diff.max()) <= 1, int(diff.max())
    assert float((diff == 0).float().mean()) >= 0.99
    torch.testing.assert_close(sy, rs, rtol=1e-4, atol=0)


QBLOCK_GRID = [(b, c) for b in (32, 64, 96, 256, 1024) for c in (128, 256)]


@pytest.mark.parametrize("b,c", QBLOCK_GRID)
def test_qblock_matches_plain(dev, b, c):
    """B=96 ends in a partial 64-board tile of the convs; B=1024 takes the
    128-board tiles and the pool kernel's 4 boards per CTA."""
    args = qblock_args(b, c, c // 2, c // 16, dev)
    before = quantized_gpbias_block.launches
    got = quantized_gpbias_block(*args, batch_tile=32)
    torch.cuda.synchronize()
    assert quantized_gpbias_block.launches == before + 1
    assert_int8_close(got, quantized_gpbias_block_reference(*args, batch_tile=32))


def test_qblock_repeats_bits_and_replays_from_a_graph(dev):
    """The tile maxima are atomicMax on f32 bits, which does not depend on
    order: a repeat gives the same bits. Replayed from a CUDA graph after
    xq's values changed in place, the block (its maxima zeroed inside the
    replay) computes the new block."""
    args = qblock_args(96, 256, 128, 16, dev, seed=7)
    got, again = (quantized_gpbias_block(*args, batch_tile=32) for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        out = quantized_gpbias_block(*args, batch_tile=32)
    new = qblock_args(96, 256, 128, 16, dev, seed=8)
    args[0].copy_(new[0])
    args[1].copy_(new[1])
    graph.replay()
    torch.cuda.synchronize()
    assert_int8_close(out, quantized_gpbias_block_reference(*args, batch_tile=32))
    graph.replay()
    torch.cuda.synchronize()
    assert_int8_close(out, quantized_gpbias_block_reference(*args, batch_tile=32))


def test_qblock_rejects_what_the_kernel_does_not_take(dev):
    args = qblock_args(32, 64, 32, 8, dev)
    with pytest.raises(ValueError, match="C in"):
        quantized_gpbias_block(*args, batch_tile=32)
    args = qblock_args(64, 128, 64, 8, dev)
    with pytest.raises(ValueError, match="not divisible"):
        quantized_gpbias_block(*args, batch_tile=48)
    args = qblock_args(64, 128, 64, 8, dev, bt=8)
    with pytest.raises(ValueError, match="multiple of 16"):
        quantized_gpbias_block(*args, batch_tile=8)


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
def test_mma_probe_matches_plain(dev, dtype):
    a, b = probe_inputs(dtype, 256, dev)
    key = "int8" if dtype == torch.int8 else "bf16"
    before = mma_chain.launches[key]
    got = mma_chain(a, b, 5)
    torch.cuda.synchronize()
    assert mma_chain.launches[key] == before + 1
    hold_to_plain(lambda *args: got, a, b, 5)


@pytest.mark.parametrize("chain", [1, 2, 8, 32])
@pytest.mark.parametrize("m", [3872, "cluster"])
@pytest.mark.parametrize("k", [512, 768])
@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
def test_gemm_chain_matches_plain(dev, dtype, k, m, chain):
    """Both probes' kernel at row 4's K and row 8's, over M = 3872 (a partial
    last tile) and the rows of a single cluster; a bf16 chain longer than 8
    step by step (hold_to_plain)."""
    rows = chain_plan(dtype, k).rows if m == "cluster" else m
    a, b = probe_inputs(dtype, rows, dev, seed=k + chain, k=k)
    hold_to_plain(mma_chain, a, b, chain)


@pytest.mark.parametrize("k", [512, 768])
@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
def test_gemm_chain_repeats_and_replays(dev, dtype, k):
    """Equal bits on a repeat and on a CUDA-graph replay on new values; one
    launch counted per call, the replayed ones by graph_ms."""
    a, b = probe_inputs(dtype, 1000, dev, k=k)
    key = "int8" if dtype == torch.int8 else "bf16"
    before = mma_chain.launches[key]
    first = mma_chain(a, b, 8)
    assert mma_chain.launches[key] == before + 1
    assert torch.equal(first, mma_chain(a, b, 8))
    assert mma_chain.launches[key] == before + 2
    static_a, static_b = a.clone(), b.clone()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = mma_chain(static_a, static_b, 8)
    a2, b2 = probe_inputs(dtype, 1000, dev, seed=7, k=k)
    static_a.copy_(a2)
    static_b.copy_(b2)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, mma_chain(a2, b2, 8))
    hold_to_plain(lambda *args: out, a2, b2, 8)
    before = mma_chain.launches[key]
    graph_ms(lambda: mma_chain(a, b, 2), iters=3, counters=(mma_chain.launches,))
    assert mma_chain.launches[key] == before + 1 + 2 * 3


@pytest.mark.parametrize("k", [512, 768])
@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
def test_gemm_chain_prefix_is_the_shorter_chain(dev, dtype, k):
    """A chain of n passes through the chain of n - 1's bits: one launch of
    a step from mma_chain(a, b, n - 1) gives mma_chain(a, b, n) exactly (the
    premise of hold_to_plain's step-by-step bound), over a partial last
    tile."""
    a, b = probe_inputs(dtype, 3872, dev, seed=k, k=k)
    for n in (2, 5, 32):
        assert torch.equal(mma_chain(mma_chain(a, b, n - 1), b, 1), mma_chain(a, b, n)), n


def test_gemm_chain_raises_and_never_falls_back(dev):
    """A K or type the kernel does not take raises before any launch."""
    before = sum(mma_chain.launches.values())
    for k in (256, 640):
        a, b = probe_inputs(torch.int8, 128, dev, k=k)
        with pytest.raises(ValueError, match="takes \\(type, K\\)"):
            mma_chain(a, b, 2)
    a, b = probe_inputs(torch.int8, 128, dev)
    with pytest.raises(TypeError, match="int8 or bfloat16"):
        mma_chain(a.half(), b.half(), 2)
    with pytest.raises(ValueError, match="768"):
        qparts.dot_chain(a, b, 2)
    assert sum(mma_chain.launches.values()) == before


@pytest.mark.parametrize("bpc", [1, 2, 4])
@pytest.mark.parametrize("b,cin,cout", [(64, 256, 256), (7, 128, 128), (6, 50, 256)])
def test_conv3x3_bpc_matches_plain(dev, bpc, b, cin, cout):
    g = torch.Generator(device="cpu").manual_seed(cin + bpc)
    x = torch.randn(9, 9, b, cin, generator=g).to(torch.bfloat16).to(dev)
    w = (torch.randn(3, 3, cin, cout, generator=g) / (9 * cin) ** 0.5).to(torch.bfloat16).to(dev)
    before = conv3x3_bpc.launches[bpc]
    got = conv3x3_bpc(x, w, boards_per_cta=bpc)
    torch.cuda.synchronize()
    assert conv3x3_bpc.launches[bpc] == before + 1
    torch.testing.assert_close(got.float(), conv3x3_hwbc_reference(x, w).float(), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("bpc", WGMMA_BOARDS)
@pytest.mark.parametrize("b,cin,cout", [(64, 256, 256), (7, 128, 128), (200, 64, 256)])
def test_conv3x3_bpc_wgmma_matches_plain(dev, bpc, b, cin, cout):
    x, w = conv_inputs(b, cin, cout, dev, seed=cin + bpc)
    before = conv3x3_bpc.launches[bpc]
    got = conv3x3_bpc(x, w, boards_per_cta=bpc)
    torch.cuda.synchronize()
    assert conv3x3_bpc.launches[bpc] == before + 1
    torch.testing.assert_close(got.float(), conv3x3_hwbc_reference(x, w).float(), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("b,c", [(32, 128), (5, 256), (130, 128), (600, 256)])
def test_fused_block_stage_matches_plain(dev, stage, b, c):
    args = stage_inputs(b, c, 64, dev)
    before = fused_block_stage.launches[stage]
    got = fused_block_stage(*args, stage=stage)
    torch.cuda.synchronize()
    assert fused_block_stage.launches[stage] == before + 1
    ref = fused_block_stage_reference(*args, stage=stage)
    if stage in EXACT_STAGES:
        assert float((got - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
    else:
        torch.testing.assert_close(got, ref, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("variant", qparts.VARIANTS)
@pytest.mark.parametrize("b,c", [(64, 256), (32, 128), (96, 256)])
def test_qblock_part_matches_plain(dev, variant, b, c):
    args = qparts.part_inputs(variant, b, c, dev, seed=b)
    before = qparts.qblock_part.launches[variant]
    got = qparts.qblock_part(variant, *args, batch_tile=32)
    torch.cuda.synchronize()
    assert qparts.qblock_part.launches[variant] == before + 1
    qparts.compare_to_plain(variant, got, qparts.qblock_part_reference(variant, *args, batch_tile=32))


def test_qblock_full_kernel_times_come_from_the_trace(dev):
    args = qparts.full_block_args(64, 256, 32, dev)
    assert [name for name, _ in qparts.FULL_KERNELS] == ["K0_pool", "K1_conv1", "Q1_requant_h",
                                                         "K2_conv2", "K3_se", "Q2_requant_y"]
    before = quantized_gpbias_block.launches
    times, traced = qparts.full_kernel_ms(args, 32, iters=3)
    # a warm-up call, then TRACE_LEAD + 3 traced ones; the means are over the last 3
    assert quantized_gpbias_block.launches == before + 1 + TRACE_LEAD + 3
    assert all(times[name] > 0 for name, _ in qparts.FULL_KERNELS)
    assert all(3 <= traced[name] <= TRACE_LEAD + 3 for name, _ in qparts.FULL_KERNELS)
    assert times["total"] == pytest.approx(sum(times[name] for name, _ in qparts.FULL_KERNELS))


def test_graph_ms_counts_replayed_launches(dev):
    a, bt = mm_inputs(torch.int8, 128, 128, 128, dev)
    before = tiled_mm.launches["int8"]
    graph_ms(lambda: tiled_mm(a, bt), iters=5, counters=(tiled_mm.launches,))
    assert tiled_mm.launches["int8"] == before + 1 + 2 * 5  # a warm-up call, 2 replays of 5
    # a wrapper that counts in an integer is passed itself
    args = block_args(4, 128, 64, 8, dev)
    before = fused_gpbias_block.launches
    graph_ms(lambda: fused_gpbias_block(*args), iters=3, counters=(fused_gpbias_block,))
    assert fused_gpbias_block.launches == before + 1 + 2 * 3


def test_fused_block_kernel_times_come_from_the_trace(dev):
    blocks = [block_args(64, 256, 128, 16, dev, seed=s)[1:] for s in range(2)]
    x = block_args(64, 256, 128, 16, dev)[0]
    before = fused_gpbias_block.launches
    times, traced = fused_profile.block_kernels_ms(x, blocks, iters=2)
    # a warm-up trunk, then TRACE_LEAD + 2 traced ones of 2 blocks each
    assert fused_gpbias_block.launches == before + 2 * (1 + TRACE_LEAD + 2)
    names = [name for name, _ in fused_profile.BLOCK_KERNELS]
    assert all(times[n] > 0 for n in names)
    assert all(2 * 2 <= traced[n] <= 2 * (TRACE_LEAD + 2) for n in names)
    assert times["total"] == pytest.approx(sum(times[n] for n in names))


@pytest.mark.parametrize("b,c", [(5, 128), (64, 256), (530, 256)])
def test_fused_block_pool_boards_give_equal_bits(dev, b, c):
    """1 or 4 boards per CTA of the pool kernel is a launch parameter only."""
    args = block_args(b, c, c // 2, c // 16, dev, seed=b)
    one = fused_gpbias_block(*args, pool_boards=1)
    four = fused_gpbias_block(*args, pool_boards=4)
    assert torch.equal(one, four) and torch.equal(one, fused_gpbias_block(*args))
    with pytest.raises(ValueError, match="pool_boards"):
        fused_gpbias_block(*args, pool_boards=2)


@pytest.mark.parametrize("chain", [3, qparts.DOT_CHAIN])
@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
def test_dot_chain_matches_plain(dev, dtype, chain):
    x, w = qparts.dot_inputs(dtype, qparts.DOT_M, dev)  # 3872 rows: a partial last tile
    key = "int8" if dtype == torch.int8 else "bf16"
    before = qparts.dot_chain.launches[key]
    got = qparts.dot_chain(x, w, chain)
    torch.cuda.synchronize()
    assert qparts.dot_chain.launches[key] == before + 1
    hold_to_plain(lambda *args: got, x, w, chain)


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(4096, 1152, 256), (100, 128, 200), (100, 1152, 136)])
def test_tiled_mm_matches_plain(dev, dtype, m, k, n):
    a, bt = mm_inputs(dtype, m, k, n, dev)
    key = "int8" if dtype == torch.int8 else "bf16"
    before = tiled_mm.launches[key]
    got = tiled_mm(a, bt)
    torch.cuda.synchronize()
    assert tiled_mm.launches[key] == before + 1
    ref = tiled_mm_reference(a, bt)
    if dtype == torch.int8:
        assert torch.equal(got, ref)
    else:
        assert float((got - ref).abs().max()) <= 1e-4 * float(ref.abs().max())


def test_update_under_a_world_size_one_nccl_group_is_bit_equal(dev):
    """The PPO update with its collectives on NCCL at world size 1 (the
    BatchNorm moments through a differentiable all-reduce, the gradient
    bucket, the trajectory's all-gathers) gives the bits of the update with
    no group: losses, parameters, BatchNorm statistics, Adam moments.
    cuDNN is made deterministic first, and two runs without a group must
    agree, or the comparison would mean nothing."""
    from _torch_parallel_ranks import trajectory

    from keisei_tpu_torch.models.registry import build_model
    from keisei_tpu_torch.parallel.distributed import (free_port, setup_distributed,
                                                       teardown_distributed)
    from keisei_tpu_torch.parallel.mesh import make_mesh
    from keisei_tpu_torch.training import ppo as P
    from keisei_tpu_torch.training.value_adapter import get_value_adapter

    data, nv = trajectory(3, T=4, N=16, league=True)
    perms = [torch.randperm(64, generator=torch.Generator().manual_seed(e)) for e in range(2)]

    def run(mesh):
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            model = build_model("se_resnet", {"num_blocks": 2, "channels": 64,
                                               "global_pool_channels": 32})[0].to(dev)
        cfg = P.KataGoPPOParams(batch_size=16, epochs_per_batch=2)
        opt = P.make_optimizer(model, cfg)
        traj = P.Trajectory(**{k: torch.from_numpy(v).to(dev) for k, v in data.items()})
        metrics = P.make_ppo_update(model, get_value_adapter("katago"), cfg, opt, mesh)(
            traj, torch.from_numpy(nv).to(dev), None, 0.01, perms=perms)
        tensors = list(model.state_dict().values()) + [
            v for st in opt.state.values() for v in st.values()]
        return metrics, tensors

    old = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        want, again = run(None), run(None)
        setup_distributed(f"localhost:{free_port()}", world_size=1, rank=0, device=dev)
        try:
            mesh = make_mesh(1, device=dev)
            got = run(mesh)
        finally:
            teardown_distributed()
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = old
    assert mesh.collectives["all_reduce"] > 0 and mesh.collectives["all_gather"] > 0
    for other in (again, got):
        assert other[0] == want[0]
        assert all(torch.equal(a, b) for a, b in zip(other[1], want[1]))


def test_program_spans_and_cupti_kernels_share_one_clock(dev):
    """A kernel launched inside a span of the program's tracer starts, and
    with a synchronize inside the span ends, within the span's [start, end]:
    the spans (time.time_ns()'s nanoseconds) and a torch.profiler trace's
    CUPTI kernel times are on one clock (utils/tracing.py,
    bench_torch/trace.py)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from keisei_tpu_torch.utils import tracing

    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        tracing.enable(events={"sleep"})
        try:
            with tracing.span("sleep", device=dev):
                torch.cuda._sleep(40_000_000)  # ~20 ms at the H100's clocks
                torch.cuda.synchronize()
        finally:
            tracing.disable()
    kernels = [(e.start_ns(), e.start_ns() + e.duration_ns())
               for e in prof.profiler.kineto_results.events()
               if e.device_type() == DeviceType.CUDA and not e.is_user_annotation()]
    (span,) = tracing.spans()
    start, end = max(kernels, key=lambda k: k[1] - k[0])
    assert end - start > 5_000_000
    assert span["start_ns"] <= start < end <= span["end_ns"], (span, start, end)
    assert span["device_ms"] == pytest.approx((end - start) / 1e6, rel=0.2)


def test_program_spans_time_on_the_card_only_the_spans_a_metric_reads(dev):
    """Under torch.profiler the tracer records CUDA events for `engine.step`
    (read by engine_ms_per_ply.train) and not for `forward`, which no
    metric reads; `enable(events=...)` names the spans to time."""
    from torch.profiler import ProfilerActivity, profile

    from keisei_tpu_torch.utils import tracing

    x = torch.randn(256, 256, device=dev)
    with profile(activities=[ProfilerActivity.CUDA]):
        for name in ("forward", "engine.step"):
            with tracing.span(name, device=dev):
                x = x @ x
    got = {s["name"]: s.get("device_ms") for s in tracing.spans()}
    assert got["forward"] is None and got["engine.step"] > 0
    tracing.enable(events={"forward", "engine.step"})
    try:
        for name in ("forward", "engine.step"):
            with tracing.span(name, device=dev):
                x = x @ x
    finally:
        tracing.disable()
    assert all(s["device_ms"] > 0 for s in tracing.spans())


def test_engine_masks_on_the_card_equal_the_cpu_engine(dev):
    """200 random plies at N=1024 (max_ply 128: truncations and resets
    included): the same actions on the CPU engine and on two card engines,
    one with TF32 matmuls and one under bf16 autocast; every ply's legal
    mask and board equal the CPU's."""
    from keisei_tpu_torch.env.vec_env import EnvCore

    n, plies = 1024, 200
    modes = {"tf32": contextlib.nullcontext,
             "bf16": lambda: torch.autocast("cuda", dtype=torch.bfloat16)}
    g = torch.Generator().manual_seed(0)
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        cpu = EnvCore(n, 128, 50, device="cpu")
        state, _, mask = cpu.init()
        envs, states = {}, {}
        for name, mode in modes.items():
            with mode():
                envs[name] = EnvCore(n, 128, 50, device=dev)
                states[name] = envs[name].init()[0]
            assert torch.equal(envs[name].reset_mask.cpu(), cpu.reset_mask)
        for t in range(plies):
            actions = torch.multinomial(mask.float(), 1, generator=g)[:, 0]
            state, out = cpu.step(state, actions)
            mask = out.legal_mask
            for name, mode in modes.items():
                with mode():
                    states[name], card_out = envs[name].step(states[name], actions.to(dev))
                assert torch.equal(card_out.legal_mask.cpu(), mask), (name, t)
                assert torch.equal(states[name].board.cpu(), state.board), (name, t)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


# -- the train path's kernels (ops/train_bn.py) ---------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [32, 128, 256])
@pytest.mark.parametrize("b", [1, 1024, 2048])
def test_train_bn_kernels_match_plain(dev, b, c, dtype):
    """Every train-path kernel, forward and backward, against its plain
    version on the same inputs (one channel of board 0 all zero, its max
    tied 81 ways): an output in bf16 within 1e-2 of max |ref|, one in f32
    (sums taken in another order) within 1e-3 (profile_train_bn.errors)."""
    train_bn_probe.check(b, c, dtype, dev)


def _train_step(model, obs, dtype=torch.bfloat16):
    with torch.autocast("cuda", dtype=dtype, enabled=dtype != torch.float32):
        out = model(obs)
    loss = (out.policy_logits.float().pow(2).mean() + out.value_logits.float().sum()
            + out.score_lead.float().pow(2).sum())
    loss.backward()
    return out


def test_train_forward_launches_the_train_kernels(dev):
    """A train-mode forward and backward on the card launches every wrapper
    of ops/train_bn.py, and every BatchNorm counts as fused under the
    tracer; eval mode launches none of them."""
    from keisei_tpu_torch.models.registry import build_model
    from keisei_tpu_torch.ops import train_bn
    from keisei_tpu_torch.utils import tracing

    model = build_model("se_resnet", {"num_blocks": 2, "channels": 64,
                                      "global_pool_channels": 32})[0].to(dev)
    obs = (torch.rand(32, 50, 9, 9, device=dev) > 0.8).float()
    wrappers = train_bn_probe.WRAPPERS
    before = [w.launches for w in wrappers]
    per_mode = train_bn_probe.launch_counts()
    tracing.enable()
    try:
        model.train()
        _train_step(model, obs)
        counts = tracing.counters()
    finally:
        tracing.disable()
    torch.cuda.synchronize()
    assert all(w.launches > n for w, n in zip(wrappers, before)), \
        {w.__name__: w.launches - n for w, n in zip(wrappers, before)}
    # each mode of the wrappers that take one (input_bn and policy_bn1 plain,
    # a block's bn1 head and bn2 tail), forward and backward
    grown = {k: v - per_mode[k] for k, v in train_bn_probe.launch_counts().items()}
    assert all(grown.values()), grown
    # input_bn, policy_bn1 and two per block
    assert counts["bn.train"] == counts["bn.train.fused"] == 2 + 2 * 2
    model.eval()
    before = [w.launches for w in wrappers]
    with torch.no_grad():
        model(obs)
    assert [w.launches for w in wrappers] == before
    assert train_bn.bn_sums.launches > 0


def _ppo_update(dev, fused: bool, monkeypatch, minibatches: int = 3):
    """Three PPO minibatches of a b10c128-sized float32 model: the update's
    loss terms, each minibatch's gradient (before the clip) and the state."""
    from _torch_parallel_ranks import trajectory

    from keisei_tpu_torch.models import se_resnet
    from keisei_tpu_torch.models.registry import build_model
    from keisei_tpu_torch.training import ppo as P
    from keisei_tpu_torch.training.value_adapter import get_value_adapter

    with monkeypatch.context() as m:
        if not fused:
            m.setattr(se_resnet, "_train_kernels", lambda x: False)
        data, nv = trajectory(5, T=minibatches, N=16)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            model = build_model("se_resnet", {"num_blocks": 10, "channels": 128,
                                              "global_pool_channels": 64, "value_fc_size": 128,
                                              "score_fc_size": 64, "dtype": "float32"})[0].to(dev)
        cfg = P.KataGoPPOParams(batch_size=16, epochs_per_batch=1)
        traj = P.Trajectory(**{k: torch.from_numpy(v).to(dev) for k, v in data.items()})
        perms = [torch.randperm(16 * minibatches, generator=torch.Generator().manual_seed(1))]
        update = P.make_ppo_update(model, get_value_adapter("katago"), cfg,
                                   P.make_optimizer(model, cfg))
        grads, backward = [], update.backward

        def recorded(*args, **kwargs):
            out = backward(*args, **kwargs)
            grads.append(torch.cat([p.grad.reshape(-1) for p in update.params]))
            return out

        update.backward = recorded
        metrics = update(traj, torch.from_numpy(nv).to(dev), None, 0.01, perms=perms)
    return metrics, grads, model.state_dict()


def test_ppo_minibatches_on_the_train_kernels_match_the_plain_path(dev, monkeypatch):
    """Three PPO minibatches of a b10c128-sized float32 model on the
    kernels and on the plain path: the loss terms over the three, the first
    minibatch's gradient (L2 over every parameter, PR 12's gate) and the
    running statistics within 1e-2, the float32 twin's bound (ROADMAP C
    item 9). Later gradients and the parameters are not compared: Adam's
    first steps are +-lr an element, so an element whose gradient is at
    rounding level steps either way on the two sides, and the third
    minibatch's gradients drift ~1% apart with the plain versions alone."""
    want, want_grads, w_state = _ppo_update(dev, False, monkeypatch)
    got, got_grads, g_state = _ppo_update(dev, True, monkeypatch)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-2, abs=1e-6), k
    assert len(got_grads) == len(want_grads) == 3
    assert float((got_grads[0] - want_grads[0]).norm()) <= 1e-2 * float(want_grads[0].norm())
    for k, v in w_state.items():
        if "running" in k:
            assert float((g_state[k] - v).norm()) <= 1e-2 * float(v.norm()), k


@pytest.mark.parametrize("share", [0.5, 1.0])
def test_synced_batch_stats_on_the_train_kernels_match_the_plain_path(dev, monkeypatch, share):
    """Under synced_batch_stats with a stand-in reduce (twice the sum, as
    two equal ranks would give), the kernels' forward, gradients and
    running statistics equal the plain path's within 1e-4 in float32."""
    from keisei_tpu_torch.models import se_resnet
    from keisei_tpu_torch.models.registry import build_model

    obs = (torch.rand(48, 50, 9, 9, device=dev) > 0.8).float()
    runs = []
    for fused in (False, True):
        with monkeypatch.context() as m:
            if not fused:
                m.setattr(se_resnet, "_train_kernels", lambda x: False)
            torch.manual_seed(0)
            model = build_model("se_resnet", {"num_blocks": 2, "channels": 64,
                                              "global_pool_channels": 32,
                                              "dtype": "float32"})[0].to(dev).train()
            with se_resnet.synced_batch_stats(model, lambda t: t * 2, share):
                out = _train_step(model, obs, torch.float32)
            runs.append((out.policy_logits.detach(),
                         {k: p.grad for k, p in model.named_parameters()},
                         {k: b for k, b in model.named_buffers()}))
    (lw, gw, bw), (lg, gg, bg) = runs
    assert float((lg - lw).abs().max()) <= 1e-4 * float(lw.abs().max())
    for k in gw:
        assert float((gg[k] - gw[k]).norm()) <= 1e-4 * max(float(gw[k].norm()), 1e-6), k
    for k in bw:
        assert float((bg[k].float() - bw[k].float()).abs().max()) <= \
            1e-4 * max(float(bw[k].float().abs().max()), 1.0), k


def test_train_kernels_reject_what_they_do_not_take(dev):
    from keisei_tpu_torch.ops import train_bn

    y = torch.randn(4, 32, 9, 9, device=dev)
    af = tuple(torch.ones(32, device=dev) for _ in range(3))
    with pytest.raises(TypeError):
        train_bn.bn_sums(y.half())
    with pytest.raises(ValueError):
        train_bn.bn_sums(y.transpose(0, 1))
    with pytest.raises(ValueError):
        train_bn.pool_stats(y.reshape(4, 32, 81))
    with pytest.raises(ValueError):
        train_bn.bn_apply("plain", y, (af[0][:16], af[1], af[2]))
    with pytest.raises(TypeError):
        train_bn.bn_apply("plain", y, (af[0].double(), af[1], af[2]))
    with pytest.raises(ValueError):
        train_bn.bn_apply("tail", y, af, x=y)
    with pytest.raises(TypeError):
        train_bn.bn_apply("head", y, af, g=torch.ones(4, 32, device=dev, dtype=torch.bfloat16))
    with pytest.raises(TypeError):
        train_bn.bn_grad_sums("head", y, y.bfloat16(), af)
    with pytest.raises(ValueError):
        train_bn.bn_apply("middle", y, af)

"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Imports no JAX, so it runs on a machine with a GPU and no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Without a card every test skips (the decision is made inside the fixture).
Tolerance: rtol = atol = 0.05 in bf16, as TestPallasConv holds the TPU
kernel to an XLA conv; both sides accumulate in f32 and round to bf16 at the
same points, so they differ only by summation order and one-ulp roundings.
The int8 block: its convs are exact on both sides, so its outputs may differ
only where an f32 sum taken in another order (pool, FCs, SE mean) moves a
value across a rounding boundary: at most 1 level apart, >= 99% identical,
scales within rtol 1e-4 (the same bound as the CPU test against JAX). The
tensor-core probe computes in exact integers and must match bit for bit.

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
"""

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
from keisei_tpu_torch.scripts.profile_int8_mma import mma_chain, mma_chain_reference, probe_inputs
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


@pytest.mark.parametrize("b,c,gpc,sec", [(64, 256, 128, 16), (256, 256, 128, 16),
                                         (32, 128, 64, 8)])
def test_qblock_matches_plain(dev, b, c, gpc, sec):
    args = qblock_args(b, c, gpc, sec, dev)
    before = quantized_gpbias_block.launches
    got = quantized_gpbias_block(*args, batch_tile=32)
    torch.cuda.synchronize()
    assert quantized_gpbias_block.launches == before + 1
    assert_int8_close(got, quantized_gpbias_block_reference(*args, batch_tile=32))


def test_qblock_rejects_what_the_kernel_does_not_take(dev):
    args = qblock_args(32, 64, 32, 8, dev)
    with pytest.raises(ValueError, match="C in"):
        quantized_gpbias_block(*args, batch_tile=32)
    args = qblock_args(64, 128, 64, 8, dev)
    with pytest.raises(ValueError, match="not divisible"):
        quantized_gpbias_block(*args, batch_tile=48)


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
def test_mma_probe_matches_plain(dev, dtype):
    a, b = probe_inputs(dtype, 256, dev)
    before = mma_chain.launches
    got = mma_chain(a, b, 5)
    torch.cuda.synchronize()
    assert mma_chain.launches == before + 1
    assert torch.equal(got, mma_chain_reference(a, b, 5))


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
@pytest.mark.parametrize("b,c", [(64, 256), (32, 128)])
def test_qblock_part_matches_plain(dev, variant, b, c):
    args = qparts.part_inputs(variant, b, c, dev, seed=b)
    before = qparts.qblock_part.launches[variant]
    got = qparts.qblock_part(variant, *args, batch_tile=32)
    torch.cuda.synchronize()
    assert qparts.qblock_part.launches[variant] == before + 1
    qparts.compare_to_plain(variant, got, qparts.qblock_part_reference(variant, *args, batch_tile=32))


def test_qblock_full_kernel_times_come_from_the_trace(dev):
    args = qparts.full_block_args(64, 256, 32, dev)
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


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
def test_dot_chain_matches_plain(dev, dtype):
    x, w = qparts.dot_inputs(dtype, qparts.DOT_M, dev)  # 3872 rows: a partial last CTA
    key = "int8" if dtype == torch.int8 else "bf16"
    before = qparts.dot_chain.launches[key]
    got = qparts.dot_chain(x, w, 3)
    torch.cuda.synchronize()
    assert qparts.dot_chain.launches[key] == before + 1
    ref = qparts.dot_chain_reference(x, w, 3)
    if dtype == torch.int8:
        assert torch.equal(got, ref)
    else:
        torch.testing.assert_close(got.float(), ref.float(), rtol=TOL, atol=TOL)


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

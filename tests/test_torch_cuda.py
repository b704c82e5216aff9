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
"""

import pytest
import torch

from keisei_tpu_torch.ops import _build
from keisei_tpu_torch.ops.conv3x3 import conv3x3_hwbc, conv3x3_hwbc_reference
from keisei_tpu_torch.ops.fused_block import fused_gpbias_block, fused_gpbias_block_reference
from keisei_tpu_torch.ops.qblock import (pack_quantized, quantize_conv_weights,
                                         quantized_gpbias_block,
                                         quantized_gpbias_block_reference)
from keisei_tpu_torch.scripts.profile_int8_mma import mma_chain, mma_chain_reference, probe_inputs

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


@pytest.mark.parametrize("b,c,gpc,sec", [(64, 256, 128, 16), (5, 128, 64, 8)])
def test_fused_block_matches_plain(dev, b, c, gpc, sec):
    args = block_args(b, c, gpc, sec, dev)
    before = fused_gpbias_block.launches
    got = fused_gpbias_block(*args)
    torch.cuda.synchronize()
    assert fused_gpbias_block.launches == before + 1
    ref = fused_gpbias_block_reference(*args)
    torch.testing.assert_close(got.float(), ref.float(), rtol=TOL, atol=TOL)


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

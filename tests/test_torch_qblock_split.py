"""What the CPU can hold of the int8 block's six-kernel split
(csrc/qblock.cu): a plain-torch transcription of its kernels, K0 -> Q2, that
passes between its stages exactly what the kernels pass (g2, h in f32, the
tile maxima as a max of f32 bit patterns taken per warp of 16 boards and
then per tile, hq, conv2's exact sums converted to f32 once, y in f32 and
its maxima per board, then per tile), and the block's launch plan. The
kernels themselves run in tests/test_torch_cuda.py.

The transcription must equal `quantized_gpbias_block_reference` bit for bit:
that fixes the rounding points the kernels follow (every product, sum and
quotient the function rounds, in the function's association). Against the
JAX kernel, interpreted, it is held to the bounds of
tests/test_torch_ops.py:test_qblock_matches_pallas (at most 1 level apart,
>= 99% identical, scales within rtol 1e-4).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keisei_tpu.ops import qblock as jax_qblock
from keisei_tpu_torch.ops.conv3x3 import wgmma_tile
from keisei_tpu_torch.ops.fused_block import POOL_4_FROM
from keisei_tpu_torch.ops.qblock import (_qconv_taps_exact, pack_quantized, qblock_plan,
                                         quantize_conv_weights, quantized_gpbias_block_reference)

torch.set_num_threads(2)


def _per_square(v):
    """The mean over the 81 squares as the kernels take it: a thread sums its
    channel's values in square order, then the IEEE quotient."""
    s = v[0]
    for m in range(1, 81):
        s = s + v[m]
    return s / torch.full_like(s, 81.0)


def _fc(v, w, b):
    """An in-block FC as the kernels take it: bf16 inputs, exact products
    summed in double, one rounding to f32, then the bias."""
    return (v.to(torch.bfloat16).double() @ w.double()).float() + b


def _tile_words(v, group, bt):
    """The tile maxima as the kernels leave them: the bits of |v| (81, n, c)
    maxed over each group of `group` boards (a warp of the conv epilogue, a
    CTA of the SE kernel), then over the groups of a tile (atomicMax on the
    words)."""
    _, n, c = v.shape
    bits = v.abs().contiguous().view(torch.int32)
    per_group = bits.reshape(81, n // group, group, c).amax(dim=(0, 2, 3))
    return per_group.reshape(n // bt, bt // group).amax(dim=1)


def _scales(words):
    """Q's tile scale from a word: amax / 127 (an IEEE quotient), 1 if 0."""
    amax = words.view(torch.float32)
    return torch.where(amax > 0, amax / torch.full_like(amax, 127.0), torch.ones_like(amax))


def _requant(v, words, bt):
    """Q: each value of v (81, n, c) rounded with its tile's scale."""
    scale = _scales(words)
    q = torch.round(v / scale.repeat_interleave(bt)[None, :, None].expand_as(v))
    return torch.clamp(q, -127, 127).to(torch.int8), scale


def split_block(xq, sx, wq1, wq2, bn, gp1_w, gp1_b, gp2_w, gp2_b, se1_w, se1_b, se2_w, se2_b,
                bt):
    """csrc/qblock.cu's six kernels, stage by stage."""
    n, c = xq.shape[2], xq.shape[3]
    m1, b1, m2, b2 = bn
    sx_b = sx.repeat_interleave(bt)
    # K0: the pool of xq * sx[tile] (its max over the zero border too) -> g2
    xf = xq.reshape(81, n, c).float() * sx_b[None, :, None]
    mean = _per_square(xf)
    pool = torch.cat([mean, xf.amax(dim=0).clamp_min(0.0),
                      torch.sqrt(_per_square((xf - mean[None]) ** 2) + 1e-10)], dim=1)
    g2 = _fc(torch.relu(_fc(pool, gp1_w, gp1_b)), gp2_w, gp2_b)
    # K1: the int32 sums converted once; sx folded into the channel multiplier
    acc1 = _qconv_taps_exact(xq, wq1).to(torch.int32)
    h = torch.relu(acc1.float() * (sx_b[:, None] * m1)[None] + b1) + g2[None]
    hmax = _tile_words(h, 16, bt)
    # Q1
    hq, sh = _requant(h, hmax, bt)
    # K2: conv2's sums, each converted to f32 once
    sums = _qconv_taps_exact(hq.reshape(9, 9, n, c), wq2).to(torch.int32).float()
    # K3: z = sum * (sh * m2) + b2, the SE, the residual; y's max per board
    z = sums * (sh.repeat_interleave(bt)[:, None] * m2)[None] + b2
    se = _fc(torch.relu(_fc(_per_square(z), se1_w, se1_b)), se2_w, se2_b)
    y = torch.relu(z * torch.sigmoid(se[:, :c])[None] + se[:, c:][None] + xf)
    ymax = _tile_words(y, 1, bt)
    # Q2
    yq, sy = _requant(y, ymax, bt)
    return yq.reshape(9, 9, n, c), sy


def _inputs(seed, b, c):
    """The same quantized operands for both packages, from numpy floats:
    (JAX args, port args), as tests/test_torch_ops.py builds them."""
    rng = np.random.default_rng(seed)
    gpc, sec = c // 2, c // 4
    f32 = np.float32
    x = np.maximum(rng.normal(size=(9, 9, b, c)), 0).astype(f32)
    w1, w2 = [(rng.normal(size=(3, 3, c, c)) / np.sqrt(9 * c)).astype(f32) for _ in range(2)]
    bn = np.stack([1 + 0.1 * rng.normal(size=c), 0.1 * rng.normal(size=c),
                   1 + 0.1 * rng.normal(size=c), 0.1 * rng.normal(size=c)]).astype(f32)
    fcs = [(0.1 * rng.normal(size=shape)).astype(f32)
           for shape in ((3 * c, gpc), gpc, (gpc, c), c, (c, sec), sec, (sec, 2 * c), 2 * c)]
    jbuf, jsx = jax_qblock.pack_quantized(jnp.asarray(x), 32)
    (jwq1, jws1), (jwq2, jws2) = [jax_qblock.quantize_conv_weights(jnp.asarray(w))
                                  for w in (w1, w2)]
    jbn = jnp.stack([bn[0] * jws1, bn[1], bn[2] * jws2, bn[3]])
    jargs = [jbuf, jsx, jwq1, jwq2, jbn, *[jnp.asarray(a) for a in fcs]]
    xq, sx = pack_quantized(torch.from_numpy(x), 32)
    (wq1, ws1), (wq2, ws2) = [quantize_conv_weights(torch.from_numpy(w)) for w in (w1, w2)]
    tb = torch.from_numpy(bn)
    tfcs = [torch.from_numpy(a).to(torch.bfloat16) if a.ndim == 2 else torch.from_numpy(a)
            for a in fcs]
    return jargs, [xq, sx, wq1, wq2, torch.stack([tb[0] * ws1, tb[1], tb[2] * ws2, tb[3]]), *tfcs]


@pytest.mark.parametrize("b,c", [(32, 32), (64, 48), (96, 16)])
def test_split_equals_plain_version_bit_for_bit(b, c):
    _, targs = _inputs(b + c, b, c)
    yq, sy = split_block(*targs, 32)
    rq, rs = quantized_gpbias_block_reference(*targs, batch_tile=32)
    assert torch.equal(yq, rq) and torch.equal(sy, rs)


def test_split_matches_pallas():
    jargs, targs = _inputs(7, 64, 32)
    yq, sy = split_block(*targs, 32)
    jy, jsy = jax_qblock.quantized_gpbias_block(*jargs, batch_tile=32, interpret=True)
    np.testing.assert_allclose(sy.numpy(), np.asarray(jsy)[:, 0], rtol=1e-4)
    interior = np.asarray(jy[12:133, :, 0:32]).reshape(11, 11, 64, 32)[1:10, 1:10]
    diff = np.abs(yq.numpy().astype(np.int32) - interior.astype(np.int32))
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.99


def test_tile_words_order_like_the_floats():
    """Non-negative f32s order like their bits, so the max of the words is
    the word of the max, whatever the order: the kernels' atomicMax."""
    v = torch.rand(81, 64, 8) * torch.logspace(-30, 30, 8)
    v[:, 32:] = 0.0
    words = _tile_words(v, 16, 32)
    want = torch.stack([v[:, :32].amax(), torch.tensor(0.0)])
    assert torch.equal(words.view(torch.float32), want)
    assert torch.equal(_scales(words), torch.stack([v[:, :32].amax() / 127.0, torch.tensor(1.0)]))


# (n, c) -> conv tile height, pool boards per CTA
PLANS = {(32, 128): (64, 1), (96, 256): (64, 1), (256, 128): (128, 1), (256, 256): (64, 1),
         (544, 256): (128, 4), (1024, 128): (128, 4), (1024, 256): (128, 4)}


@pytest.mark.parametrize("n,c", list(PLANS))
def test_qblock_plan(n, c):
    plan = qblock_plan(n, c)
    assert plan.tile == wgmma_tile(n, c) and plan.tile.cout_tile == c and plan.tile.persistent
    assert (plan.tile.boards, plan.pool_boards) == PLANS[(n, c)]
    assert plan.pool_boards == (4 if n >= POOL_4_FROM else 1)
    # g2 (n, c) f32, act (9, 9, n, c) f32, hq (9, 9, n, c) int8, stats 3 words per tile
    assert (plan.g2_bytes, plan.act_bytes, plan.hq_bytes) == (4 * n * c, 324 * n * c, 81 * n * c)
    assert plan.stats_bytes == -(-12 * (n // 32) // 16) * 16 >= 12 * (n // 32)
    parts = (plan.g2_bytes, plan.act_bytes, plan.hq_bytes, plan.stats_bytes)
    assert all(p % 16 == 0 for p in parts) and plan.scratch_bytes == sum(parts)
    assert qblock_plan(n, c, 64 if n % 64 == 0 else 32).stats_bytes <= plan.stats_bytes


def test_qblock_plan_refuses_what_the_kernels_do_not_take():
    for c in (64, 192):
        with pytest.raises(ValueError, match="C in"):
            qblock_plan(64, c)
    with pytest.raises(ValueError, match="not divisible"):
        qblock_plan(80, 256)
    with pytest.raises(ValueError, match="multiple of 16"):
        qblock_plan(64, 256, 8)

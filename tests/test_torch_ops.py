"""The plain versions of the port's kernels against the JAX Pallas kernels.

The Pallas kernels run with interpret=True, as tests/test_fused_infer.py
runs them on the CPU; the port's wrappers take their plain PyTorch versions
because the tensors lie on the CPU, which must leave the CUDA launch
counters at 0. Inputs are made with numpy and rounded to bf16 identically
on both sides. Tolerance rtol = atol = 0.05 (bf16 outputs, f32 sums in a
different order: the TestPallasConv bound).

The int8 block (ops/qblock.py) is held to keisei_tpu/ops/qblock.py with the
Pallas kernel interpreted, on the dequantized interior values of the JAX
banded layout. Its convs are exact integer sums on both sides; only f32
sums taken in another order (pool, FCs, SE mean) can move a value across a
rounding boundary. Measured here: at most 1 level apart and >= 99.99%
identical; the test holds them to at most 1 level, >= 99% identical, and
the tile scales to rtol 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keisei_tpu.ops.conv3x3 import conv3x3_hwbc as jax_conv3x3
from keisei_tpu.ops import qblock as jax_qblock
from keisei_tpu.ops.fused_block import fused_gpbias_block as jax_fused_block
from keisei_tpu_torch.ops.conv3x3 import conv3x3_hwbc
from keisei_tpu_torch.ops.fused_block import fused_gpbias_block
from keisei_tpu_torch.ops.qblock import (int8_batch_tile, pack_quantized, quantize_conv_weights,
                                         quantized_gpbias_block, unpack_dequantized)
from keisei_tpu_torch.scripts.profile_int8_mma import mma_chain, probe_inputs

torch.set_num_threads(2)
TOL = 0.05


def _pair(a: np.ndarray, bf16: bool = True):
    a = a.astype(np.float32)
    if bf16:
        return jnp.asarray(a).astype(jnp.bfloat16), torch.from_numpy(a).to(torch.bfloat16)
    return jnp.asarray(a), torch.from_numpy(a)


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x.astype(jnp.float32))


@pytest.mark.parametrize("cin,cout", [(50, 32), (32, 32)])
def test_conv3x3_matches_pallas(cin, cout):
    rng = np.random.default_rng(cin)
    jx, tx = _pair(rng.normal(size=(9, 9, 8, cin)))
    jw, tw = _pair(rng.normal(size=(3, 3, cin, cout)) / np.sqrt(9 * cin))
    conv3x3_hwbc.launches = 0
    got = conv3x3_hwbc(tx, tw)
    assert conv3x3_hwbc.launches == 0
    assert got.shape == (9, 9, 8, cout) and got.dtype == torch.bfloat16
    ref = jax_conv3x3(jx, jw, batch_tile=8, interpret=True)
    np.testing.assert_allclose(_f32(got), _f32(ref), rtol=TOL, atol=TOL)


def _block_inputs(seed, b=8, c=32, gpc=16, sec=8):
    rng = np.random.default_rng(seed)
    s = 1.0 / np.sqrt(9 * c)
    bn = np.stack([1 + 0.1 * rng.normal(size=c), 0.1 * rng.normal(size=c),
                   1 + 0.1 * rng.normal(size=c), 0.1 * rng.normal(size=c)])
    arrays = [
        (np.maximum(rng.normal(size=(9, 9, b, c)), 0), True),
        (rng.normal(size=(3, 3, c, c)) * s, True), (rng.normal(size=(3, 3, c, c)) * s, True),
        (bn, False),
        (rng.normal(size=(3 * c, gpc)) * 0.1, True), (rng.normal(size=gpc) * 0.1, False),
        (rng.normal(size=(gpc, c)) * 0.1, True), (rng.normal(size=c) * 0.1, False),
        (rng.normal(size=(c, sec)) * 0.1, True), (rng.normal(size=sec) * 0.1, False),
        (rng.normal(size=(sec, 2 * c)) * 0.1, True), (rng.normal(size=2 * c) * 0.1, False),
    ]
    pairs = [_pair(a, bf16) for a, bf16 in arrays]
    return [p[0] for p in pairs], [p[1] for p in pairs]


@pytest.mark.parametrize("seed", [0, 1])
def test_fused_block_matches_pallas(seed):
    jargs, targs = _block_inputs(seed)
    fused_gpbias_block.launches = 0
    got = fused_gpbias_block(*targs)
    assert fused_gpbias_block.launches == 0
    ref = jax_fused_block(*jargs, batch_tile=8, interpret=True)
    assert got.shape == ref.shape and got.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(got), _f32(ref), rtol=TOL, atol=TOL)


def test_wrappers_reject_bad_operands():
    _, targs = _block_inputs(2)
    with pytest.raises(TypeError):
        fused_gpbias_block(targs[0].float(), *targs[1:])
    with pytest.raises(ValueError, match="gp2_b"):
        fused_gpbias_block(*targs[:7], targs[7][:-1], *targs[8:])
    x = torch.zeros(9, 9, 2, 8, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="mismatch"):
        conv3x3_hwbc(x, torch.zeros(3, 3, 4, 8, dtype=torch.bfloat16))


def _jax_interior(buf, ch):
    """Band 0 of a (145, B, 3C) banded buffer -> (9, 9, B, C) numpy."""
    n = buf.shape[1]
    return np.asarray(buf[12:133, :, 0:ch]).reshape(11, 11, n, ch)[1:10, 1:10]


@pytest.mark.parametrize("c", [32, 128])
def test_quantize_conv_weights_matches_jax(c):
    w = (np.random.default_rng(c).normal(size=(3, 3, c, c)) / np.sqrt(9 * c)).astype(np.float32)
    jwq, jws = jax_qblock.quantize_conv_weights(jnp.asarray(w))
    wq, ws = quantize_conv_weights(torch.from_numpy(w))
    assert wq.shape == (3, 3, c, c) and wq.dtype == torch.int8
    np.testing.assert_allclose(ws.numpy(), np.asarray(jws), rtol=1e-4)
    # the port lays the weights out (3, 3, Cout, Cin); JAX row-packs (3, 3Cin, Cout)
    back = wq.permute(0, 1, 3, 2).float().numpy() * ws.numpy()
    jback = np.asarray(jwq).reshape(3, 3, c, c).astype(np.float32) * np.asarray(jws)
    np.testing.assert_allclose(back, jback, rtol=1e-4, atol=0)


@pytest.mark.parametrize("c,b", [(32, 32), (128, 64)])
def test_pack_unpack_matches_jax(c, b):
    x = np.abs(np.random.default_rng(c + b).normal(size=(9, 9, b, c))).astype(np.float32)
    jbuf, jsx = jax_qblock.pack_quantized(jnp.asarray(x), 32)
    xq, sx = pack_quantized(torch.from_numpy(x), 32)
    assert xq.shape == (9, 9, b, c) and xq.dtype == torch.int8 and sx.shape == (b // 32,)
    np.testing.assert_allclose(sx.numpy(), np.asarray(jsx)[:, 0], rtol=1e-4)
    np.testing.assert_array_equal(xq.numpy(), _jax_interior(jbuf, c))
    np.testing.assert_allclose(unpack_dequantized(xq, sx, 32).numpy(),
                               np.asarray(jax_qblock.unpack_dequantized(jbuf, jsx, 32)),
                               rtol=1e-4, atol=0)


def _qblock_inputs(seed, b, c):
    """The same quantized operands for both packages, from numpy floats:
    (JAX args, port args)."""
    rng = np.random.default_rng(seed)
    gpc, sec = c // 2, c // 4
    f32 = np.float32
    x = np.maximum(rng.normal(size=(9, 9, b, c)), 0).astype(f32)
    w1, w2 = [(rng.normal(size=(3, 3, c, c)) / np.sqrt(9 * c)).astype(f32) for _ in range(2)]
    bn = np.stack([1 + 0.1 * rng.normal(size=c), 0.1 * rng.normal(size=c),
                   1 + 0.1 * rng.normal(size=c), 0.1 * rng.normal(size=c)]).astype(f32)
    fcs = [rng.normal(size=(3 * c, gpc)), rng.normal(size=gpc), rng.normal(size=(gpc, c)),
           rng.normal(size=c), rng.normal(size=(c, sec)), rng.normal(size=sec),
           rng.normal(size=(sec, 2 * c)), rng.normal(size=2 * c)]
    fcs = [(a * 0.1).astype(f32) for a in fcs]

    jbuf, jsx = jax_qblock.pack_quantized(jnp.asarray(x), 32)
    (jwq1, jws1), (jwq2, jws2) = [jax_qblock.quantize_conv_weights(jnp.asarray(w))
                                  for w in (w1, w2)]
    jbn = jnp.stack([bn[0] * jws1, bn[1], bn[2] * jws2, bn[3]])
    jargs = [jbuf, jsx, jwq1, jwq2, jbn, *[jnp.asarray(a) for a in fcs]]

    xq, sx = pack_quantized(torch.from_numpy(x), 32)
    (wq1, ws1), (wq2, ws2) = [quantize_conv_weights(torch.from_numpy(w)) for w in (w1, w2)]
    bnt = torch.from_numpy(bn)
    tbn = torch.stack([bnt[0] * ws1, bnt[1], bnt[2] * ws2, bnt[3]])
    tfcs = [torch.from_numpy(a).to(torch.bfloat16) if a.ndim == 2 else torch.from_numpy(a)
            for a in fcs]
    return jargs, [xq, sx, wq1, wq2, tbn, *tfcs]


@pytest.mark.parametrize("c,b", [(32, 32), (32, 64), (128, 32), (128, 64)])
def test_qblock_matches_pallas(c, b):
    jargs, targs = _qblock_inputs(c + b, b, c)
    quantized_gpbias_block.launches = 0
    yq, sy = quantized_gpbias_block(*targs, batch_tile=32)
    assert quantized_gpbias_block.launches == 0
    assert yq.shape == (9, 9, b, c) and yq.dtype == torch.int8 and sy.shape == (b // 32,)
    jy, jsy = jax_qblock.quantized_gpbias_block(*jargs, batch_tile=32, interpret=True)
    np.testing.assert_allclose(sy.numpy(), np.asarray(jsy)[:, 0], rtol=1e-4)
    diff = np.abs(yq.numpy().astype(np.int32) - _jax_interior(jy, c).astype(np.int32))
    assert diff.max() <= 1, diff.max()
    assert (diff == 0).mean() >= 0.99, (diff == 0).mean()
    # and the dequantized values agree to one level of the tile scale
    got = unpack_dequantized(yq, sy, 32).numpy()
    ref = np.asarray(jax_qblock.unpack_dequantized(jy, jsy, 32))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1.0001 * float(np.asarray(jsy).max()))


def test_int8_wrappers_reject_bad_operands():
    _, targs = _qblock_inputs(0, 32, 32)
    with pytest.raises(ValueError, match="not divisible"):
        quantized_gpbias_block(*targs, batch_tile=64)
    with pytest.raises(TypeError, match="xq"):
        quantized_gpbias_block(targs[0].float(), *targs[1:], batch_tile=32)
    with pytest.raises(ValueError, match="wq2"):
        quantized_gpbias_block(*targs[:3], targs[3][:, :, :8], *targs[4:], batch_tile=32)
    assert int8_batch_tile(64) == 32 and int8_batch_tile(96) == 32
    for n in (48, 8, 200):
        with pytest.raises(ValueError, match="divisible by 32"):
            int8_batch_tile(n)


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
def test_mma_probe_plain_version(dtype):
    """The probe's plain version (what its wrapper runs on CPU tensors)
    against a numpy loop of the TPU kernel's chain (profile_int8_mxu.py:
    X <- (X @ B) & 1 in int8, exact; X <- bf16(f32(X @ B) * 1e-3) in bf16,
    at the bf16 bound), with b = B^T at the script's K = 512."""
    a, b = probe_inputs(dtype, 128, "cpu")
    assert tuple(b.shape) == (512, 512)
    mma_chain.launches.clear()
    got = mma_chain(a, b, 3)
    assert not mma_chain.launches and got.dtype == dtype
    if dtype == torch.int8:
        x, bm = a.float().numpy().astype(np.int64), b.float().numpy().astype(np.int64)
        for _ in range(3):
            x = (x @ bm.T) & 1
        np.testing.assert_array_equal(got.float().numpy(), x)
        return
    x, bm = a.float().numpy(), b.float().numpy()
    for _ in range(3):
        x = torch.from_numpy((x @ bm.T) * np.float32(1e-3)).to(torch.bfloat16).float().numpy()
    assert np.abs(x).max() > 0.1  # magnitudes of order one along the chain
    np.testing.assert_allclose(got.float().numpy(), x, rtol=TOL, atol=TOL)

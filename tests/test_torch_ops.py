"""The plain versions of the port's kernels against the JAX Pallas kernels.

The Pallas kernels run with interpret=True, as tests/test_fused_infer.py
runs them on the CPU; the port's wrappers take their plain PyTorch versions
because the tensors lie on the CPU, which must leave the CUDA launch
counters at 0. Inputs are made with numpy and rounded to bf16 identically
on both sides. Tolerance rtol = atol = 0.05 (bf16 outputs, f32 sums in a
different order: the TestPallasConv bound).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keisei_tpu.ops.conv3x3 import conv3x3_hwbc as jax_conv3x3
from keisei_tpu.ops.fused_block import fused_gpbias_block as jax_fused_block
from keisei_tpu_torch.ops.conv3x3 import conv3x3_hwbc, pick_batch_tile
from keisei_tpu_torch.ops.fused_block import fused_gpbias_block

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


def test_pick_batch_tile():
    assert pick_batch_tile(1024) == 16
    assert pick_batch_tile(8) == 8
    assert pick_batch_tile(48, 32) == 24

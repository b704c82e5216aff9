"""The probes' plain versions (rows 5-8 of PERF.md's kernel table) against
the JAX scripts whose Pallas kernels they replace, on the CPU.

The scripts stay as they are; their kernels run with interpret=True:
scripts/debug_fused_block.py:run_stage takes `interpret`; for
profile_pallas_conv.py:_conv_kernel, profile_conv_alternatives.py:_mm_kernel
/ _mm_kernel_bf16 and profile_qblock_parts.py:_convs_kernel the test repeats
the script's pallas_call spec around the module-level kernel body (the
scripts' own calls are closures). profile_qblock_parts.py reads
int(sys.argv[1]) at import, so it is imported with sys.argv patched.

The TPU's stripped int8 variants do not mask the 11x11 border of their
banded layout, so where border garbage reaches an output (convs, novpu,
bf16gemm) the port's variants are held to a numpy transcription of the
kernel body with the production rule's mask applied before each
nonlinearity; vpuonly and gemmonly's conv1 half are defined on the interior
and are held to the interpreted kernel. make_dotrate's chain is held to a
numpy transcription of its kernel body.

Tolerances: exact for integer outputs without a tile quantization; at most
1 level apart and >= 99% identical after one (the same f32 operations on
both sides, so in practice exact); f32 stage outputs before any bf16
rounding within 1e-4 of the largest |value| (f32 sums in another order);
outputs after a bf16 rounding rtol = atol = 0.05.
"""

import functools
import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from keisei_tpu.ops import qblock as jax_qblock
from keisei_tpu_torch.ops.conv3x3 import BOARDS_PER_CTA, conv3x3_bpc
from keisei_tpu_torch.ops.fused_block import STAGES, fused_block_stage
from keisei_tpu_torch.scripts import profile_conv_alternatives as port_alt
from keisei_tpu_torch.scripts import profile_qblock_parts as port_qparts

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]
TOL = 0.05
F32_TOL = 1e-4


def _load_script(name: str):
    spec = importlib.util.spec_from_file_location(f"_tpu_script_{name}",
                                                  REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def tpu_qparts():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", ["profile_qblock_parts.py"])
        return _load_script("profile_qblock_parts")


def _assert_levels(got: np.ndarray, ref: np.ndarray) -> None:
    diff = np.abs(got.astype(np.int32) - ref.astype(np.int32))
    assert diff.max() <= 1, diff.max()
    assert (diff == 0).mean() >= 0.99, (diff == 0).mean()


# ------------------------------------------------ row 5: the stage harness

@pytest.fixture(scope="module")
def stage_case():
    """debug_fused_block.py's operands at its own B=32, C=128, GPC=64, from a
    numpy seed (the script's main draws them from jax.random)."""
    mod = _load_script("debug_fused_block")
    b, c, gpc = mod.B, mod.C, mod.GPC
    rng = np.random.default_rng(5)
    f32 = np.float32
    s1 = np.exp(rng.normal(size=c) * 0.1)
    b1 = rng.normal(size=c) * 0.1
    arrays = dict(x=rng.normal(size=(9, 9, b, c)) * 0.5, w1=rng.normal(size=(3, 3, c, c)) * 0.05,
                  w2=rng.normal(size=(3, 3, c, c)) * 0.05, bn=np.stack([s1, b1, s1, b1]),
                  gp1w=rng.normal(size=(3 * c, gpc)) * 0.1, gp1b=np.full((1, gpc), 0.05),
                  gp2w=rng.normal(size=(gpc, c)) * 0.1, gp2b=np.full((1, c), 0.01))
    bf16_names = ("x", "w1", "w2", "gp1w", "gp2w")
    jargs = [jnp.asarray(a.astype(f32)).astype(jnp.bfloat16) if k in bf16_names
             else jnp.asarray(a.astype(f32)) for k, a in arrays.items()]
    targs = [torch.from_numpy(a.astype(f32)).to(torch.bfloat16) if k in bf16_names
             else torch.from_numpy(a.astype(f32)).reshape(-1 if k.endswith("b") else a.shape)
             for k, a in arrays.items()]
    return mod, jargs, targs


@pytest.mark.parametrize("stage", STAGES)
def test_fused_block_stage_matches_run_stage(stage_case, stage):
    mod, jargs, targs = stage_case
    fused_block_stage.launches.clear()
    got = fused_block_stage(*targs, stage=stage).numpy()
    assert not fused_block_stage.launches
    ref = np.asarray(mod.run_stage(stage, *jargs, interpret=True))
    assert got.shape == ref.shape == (9, 9, mod.B, mod.C) and got.dtype == np.float32
    if stage in ("conv1", "bnrelu", "pool"):   # f32, before any bf16 rounding
        assert np.abs(got - ref).max() <= F32_TOL * np.abs(ref).max()
    else:                                       # FC inputs / h rounded to bf16
        np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)


# ------------------------------------------ row 6: boards-per-CTA conv

@pytest.mark.parametrize("c", [32, 64])
def test_conv3x3_bpc_matches_pallas_conv(c):
    mod = _load_script("profile_pallas_conv")
    b, b_t = 16, 8
    rng = np.random.default_rng(c)
    x = rng.normal(size=(9, 9, b, c)).astype(np.float32)
    w = (rng.normal(size=(3, 3, c, c)) * 0.05).astype(np.float32)
    jx, jw = jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(w).astype(jnp.bfloat16)
    # profile_pallas_conv.py:86-104, pallas_conv's spec, interpreted
    ref = pl.pallas_call(
        mod._conv_kernel,
        out_shape=jax.ShapeDtypeStruct((9, 9, b, c), jnp.bfloat16),
        grid=(b // b_t,),
        in_specs=[pl.BlockSpec((9, 9, b_t, c), lambda i: (0, 0, i, 0), memory_space=pltpu.VMEM),
                  pl.BlockSpec((3, 3, c, c), lambda i: (0, 0, 0, 0), memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((9, 9, b_t, c), lambda i: (0, 0, i, 0), memory_space=pltpu.VMEM),
        scratch_shapes=[pltpu.VMEM((11, 11, b_t, c), jnp.bfloat16)],
        interpret=True,
    )(jx, jw)
    ref = np.asarray(ref.astype(jnp.float32))
    tx, tw = torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(w).to(torch.bfloat16)
    conv3x3_bpc.launches.clear()
    for bpc in BOARDS_PER_CTA:
        got = conv3x3_bpc(tx, tw, boards_per_cta=bpc)
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), ref, rtol=TOL, atol=TOL)
    assert not conv3x3_bpc.launches
    with pytest.raises(ValueError, match="boards_per_cta"):
        conv3x3_bpc(tx, tw, boards_per_cta=3)


# ------------------------------------------------- row 7: the tiled GEMM

@pytest.mark.parametrize("dtype", ["int8", "bf16"])
def test_tiled_mm_matches_pallas_mm(dtype):
    mod = _load_script("profile_conv_alternatives")
    gm, gk, gn, tm = 256, 128, 128, 128
    rng = np.random.default_rng(7)
    if dtype == "int8":
        a = rng.integers(-127, 128, size=(gm, gk)).astype(np.int8)
        b = rng.integers(-127, 128, size=(gk, gn)).astype(np.int8)
        ja, jb, kern, odt = jnp.asarray(a), jnp.asarray(b), mod._mm_kernel, jnp.int32
        ta, tbt = torch.from_numpy(a), torch.from_numpy(np.ascontiguousarray(b.T))
    else:
        a = rng.normal(size=(gm, gk)).astype(np.float32)
        b = rng.normal(size=(gk, gn)).astype(np.float32)
        ja, jb = jnp.asarray(a).astype(jnp.bfloat16), jnp.asarray(b).astype(jnp.bfloat16)
        kern, odt = mod._mm_kernel_bf16, jnp.float32
        ta = torch.from_numpy(a).to(torch.bfloat16)
        tbt = torch.from_numpy(np.ascontiguousarray(b.T)).to(torch.bfloat16)
    # profile_conv_alternatives.py:193-203, make_pallas_mm's spec, interpreted
    ref = pl.pallas_call(
        kern,
        out_shape=jax.ShapeDtypeStruct((gm, gn), odt),
        grid=(gm // tm,),
        in_specs=[pl.BlockSpec((tm, gk), lambda i: (i, 0), memory_space=pltpu.VMEM),
                  pl.BlockSpec((gk, gn), lambda i: (0, 0), memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((tm, gn), lambda i: (i, 0), memory_space=pltpu.VMEM),
        interpret=True,
    )(ja, jb)
    ref = np.asarray(ref)
    port_alt.tiled_mm.launches.clear()
    got = port_alt.tiled_mm(ta, tbt).numpy()
    assert not port_alt.tiled_mm.launches
    if dtype == "int8":
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, ref)
    else:
        assert got.dtype == np.float32
        assert np.abs(got - ref).max() <= F32_TOL * np.abs(ref).max()


def test_winograd_matches_jax_winograd():
    """Not a kernel (XLA ops in the JAX script, torch ops here): the same
    F(2x2, 3x3) transforms; the port's tile GEMM rounds to bf16 where XLA's
    dot returned f32, hence the bf16 bound."""
    mod = _load_script("profile_conv_alternatives")
    rng = np.random.default_rng(2)
    x = rng.normal(size=(4, 9, 9, 32)).astype(np.float32)
    w = (rng.normal(size=(3, 3, 32, 32)) * 0.1).astype(np.float32)
    ref = np.asarray(mod.wino2_conv(jnp.asarray(x).astype(jnp.bfloat16),
                                    mod.wino2_weights(jnp.asarray(w))).astype(jnp.float32))
    got = port_alt.wino2_conv(torch.from_numpy(x).to(torch.bfloat16),
                              port_alt.wino2_weights(torch.from_numpy(w)))
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=TOL, atol=TOL)


# ---------------------------------------- row 8: the stripped int8 block

B8, C8, BT8 = 64, 32, 32    # two quantization tiles


def _interior_mask() -> np.ndarray:
    pos = np.arange(121)
    r, c = pos // 11, pos % 11
    return ((r >= 1) & (r <= 9) & (c >= 1) & (c <= 9)).astype(np.float32)[:, None, None]


def _banded(x: np.ndarray) -> np.ndarray:
    """(9, 9, B, C) -> the (145, B, 3C) banded padded-flat layout of
    keisei_tpu/ops/qblock.py:pack_quantized, zero border and margins."""
    n, ch = x.shape[2], x.shape[3]
    flat = np.pad(x, ((1, 1), (1, 1), (0, 0), (0, 0))).reshape(121, n, ch)
    base = np.pad(flat, ((12, 12), (0, 0), (0, 0)))
    bands = [base] + [np.concatenate([base[b:], np.zeros((b, n, ch), x.dtype)])
                      for b in range(1, 3)]
    return np.concatenate(bands, axis=-1)


def _interior(buf: np.ndarray, ch: int) -> np.ndarray:
    """Band 0 of a (145, B, 3C) banded buffer -> (9, 9, B, C)."""
    return _board(buf[12:133, :, 0:ch])


def _board(rows: np.ndarray) -> np.ndarray:
    """(121, B, C) padded-flat rows -> the (9, 9, B, C) interior."""
    return rows.reshape(11, 11, rows.shape[1], rows.shape[2])[1:10, 1:10]


def _conv_rows(buf: np.ndarray, wr: np.ndarray, dtype) -> np.ndarray:
    """keisei_tpu/ops/qblock.py:_qconv_rows in numpy: 3 window GEMMs."""
    bt, k = buf.shape[1], buf.shape[2]
    acc = 0
    for d, off in enumerate(jax_qblock._ROW_OFFSETS):
        win = buf[12 + off:133 + off].reshape(121 * bt, k).astype(dtype)
        acc = acc + win @ wr[d].astype(dtype)
    return acc.reshape(121, bt, -1)


def _quantize_tile(v: np.ndarray) -> np.ndarray:
    """keisei_tpu/ops/qblock.py:_quantize_tile in numpy f32."""
    amax = np.abs(v).max()
    scale = amax / np.float32(127.0) if amax > 0 else np.float32(1.0)
    return np.clip(np.round(v / scale), -127, 127).astype(np.int8)


def _bf16(v: np.ndarray) -> np.ndarray:
    return torch.from_numpy(np.ascontiguousarray(v, np.float32)).to(torch.bfloat16).float().numpy()


def _stripped_np(variant: str, x: np.ndarray, w1r: np.ndarray, w2r: np.ndarray) -> np.ndarray:
    """profile_qblock_parts.py:_convs_kernel (:76-105; novpu, convs) and
    _bf16_kernel (:108-137; bf16gemm) in numpy, per grid step of BT8
    boards, with the interior mask applied before each nonlinearity and
    zero margins (the production rule; the TPU kernels leave both unmasked)."""
    mask = _interior_mask()
    outs = []
    for t in range(0, x.shape[2], BT8):
        buf = _banded(x[:, :, t:t + BT8])
        if variant == "bf16gemm":
            h = _bf16(_conv_rows(buf.astype(np.float32), w1r, np.float32) * np.float32(1e-2))
            y = _bf16(_conv_rows(_banded(_board(h * mask)), w2r, np.float32) * np.float32(1e-2))
            outs.append(_board(y))
            continue
        acc1 = _conv_rows(buf, w1r, np.int64)
        if variant == "convs":
            hq = _quantize_tile(np.maximum(acc1.astype(np.float32) * np.float32(1e-4), 0) * mask)
        else:  # novpu
            hq = ((acc1 & 1) * mask.astype(np.int64)).astype(np.int8)
        acc2 = _conv_rows(_banded(_board(hq)), w2r, np.int64)
        yq = np.clip(acc2, -127, 127) if variant == "convs" else acc2 & 1
        outs.append(_board(yq.astype(np.int8)))
    return np.concatenate(outs, axis=2)


def _int8_case(seed: int, sparse: bool):
    """int8 x in [-127, 127] and two weights, as the port's (3, 3, Cout,
    Cin) and the TPU script's row-packed (3, 3C, C). `sparse` keeps conv2's
    sums mostly inside +-127 so that convs' clip is not all saturated."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-127, 128, size=(9, 9, B8, C8)).astype(np.int8)
    ws = []
    for _ in range(2):
        w = rng.integers(-127, 128, size=(3, 3, C8, C8))
        if sparse:
            w = np.sign(w) * (rng.random(w.shape) < 0.2)
        ws.append(w.astype(np.int8))
    port = [torch.from_numpy(np.ascontiguousarray(w.transpose(0, 1, 3, 2))) for w in ws]
    rows = [w.reshape(3, 3 * C8, C8) for w in ws]
    return x, ws, port, rows


@pytest.mark.parametrize("variant", ["convs", "novpu"])
def test_stripped_int8_variants_match_masked_transcription(variant):
    x, _, (tw1, tw2), (w1r, w2r) = _int8_case(11, sparse=variant == "convs")
    port_qparts.qblock_part.launches.clear()
    got = port_qparts.qblock_part(variant, torch.from_numpy(x), tw1, tw2, batch_tile=BT8)
    assert not port_qparts.qblock_part.launches
    ref = _stripped_np(variant, x, w1r, w2r)
    if variant == "convs":
        assert 0.05 < (np.abs(ref) < 127).mean() < 0.95   # the clip does not decide all
        _assert_levels(got.numpy(), ref)
    else:
        np.testing.assert_array_equal(got.numpy(), ref)


def test_stripped_bf16gemm_matches_masked_transcription():
    rng = np.random.default_rng(12)
    x = _bf16(rng.normal(size=(9, 9, B8, C8)))
    ws = [_bf16(rng.normal(size=(3, 3, C8, C8)) * (100 / np.sqrt(9 * C8))) for _ in range(2)]
    t = [torch.from_numpy(a).to(torch.bfloat16) for a in (x, *ws)]
    got = port_qparts.qblock_part("bf16gemm", *t, batch_tile=BT8).float().numpy()
    ref = _stripped_np("bf16gemm", x, *[w.reshape(3, 3 * C8, C8) for w in ws])
    assert np.abs(ref).max() > 0.5
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)


def _tpu_stripped(mod, kern, xbuf, w1r, w2r):
    """profile_qblock_parts.py:157-176, make_stripped's spec, interpreted."""
    n, chb = xbuf.shape[1], xbuf.shape[2]
    return pl.pallas_call(
        kern,
        out_shape=jax.ShapeDtypeStruct((145, n, chb), xbuf.dtype),
        grid=(n // mod.BT,),
        in_specs=[pl.BlockSpec((145, mod.BT, chb), lambda i: (0, i, 0), memory_space=pltpu.VMEM),
                  pl.BlockSpec((3, chb, mod.CH), lambda i: (0, 0, 0), memory_space=pltpu.VMEM),
                  pl.BlockSpec((3, chb, mod.CH), lambda i: (0, 0, 0), memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((145, mod.BT, chb), lambda i: (0, i, 0), memory_space=pltpu.VMEM),
        scratch_shapes=[pltpu.VMEM((145, mod.BT, chb), xbuf.dtype)],
        interpret=True,
    )(xbuf, w1r, w2r)


def test_vpuonly_matches_interpreted_kernel(tpu_qparts, monkeypatch):
    for name, value in (("B", B8), ("CH", C8), ("BT", BT8)):
        monkeypatch.setattr(tpu_qparts, name, value)
    x, _, (tw1, tw2), (w1r, w2r) = _int8_case(13, sparse=False)
    kern = functools.partial(tpu_qparts._convs_kernel, vpu=True, gemm=False, store=True)
    ref = _tpu_stripped(tpu_qparts, kern, jnp.asarray(_banded(x)), jnp.asarray(w1r),
                        jnp.asarray(w2r))
    got = port_qparts.qblock_part("vpuonly", torch.from_numpy(x), tw1, tw2, batch_tile=BT8)
    _assert_levels(got.numpy(), _interior(np.asarray(ref), C8))


def test_gemmonly_conv1_matches_interpreted_kernel(tpu_qparts, monkeypatch):
    """gemmonly stores conv1's half one flat row down (o[13:134] = hq, :105),
    so the interpreted output's interior column j holds conv1 & 1 at column
    j - 1: columns 0..7 of the port's first half."""
    for name, value in (("B", B8), ("CH", C8), ("BT", BT8)):
        monkeypatch.setattr(tpu_qparts, name, value)
    x, _, (tw1, tw2), (w1r, w2r) = _int8_case(14, sparse=False)
    kern = functools.partial(tpu_qparts._convs_kernel, vpu=False, gemm=True, store=False)
    ref = _interior(np.asarray(_tpu_stripped(tpu_qparts, kern, jnp.asarray(_banded(x)),
                                             jnp.asarray(w1r), jnp.asarray(w2r))), C8)
    got = port_qparts.qblock_part("gemm3d", torch.from_numpy(x), tw1, tw2, batch_tile=BT8)
    assert got.shape == (2, 9, 9, B8, C8)
    np.testing.assert_array_equal(got[0, :, :8].numpy(), ref[:, 1:])
    # the second half, conv2(x) & 1, through the banded transcription
    parity = (_conv_rows(_banded(x), w2r, np.int64) & 1).astype(np.int8)
    np.testing.assert_array_equal(got[1].numpy(), _board(parity))


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
def test_dot_chain_matches_dotrate_transcription(dtype):
    """make_dotrate's kernel body (profile_qblock_parts.py:229-235) in numpy:
    X <- (X @ W) & 1 in int64, or X <- bf16(f32(X @ W) * 1e-3)."""
    x, wt = port_qparts.dot_inputs(dtype, 40, "cpu", seed=3)
    port_qparts.dot_chain.launches.clear()
    got = port_qparts.dot_chain(x, wt, port_qparts.DOT_CHAIN).float().numpy()
    assert not port_qparts.dot_chain.launches
    xn, wn = x.float().numpy(), wt.float().numpy().T
    for _ in range(port_qparts.DOT_CHAIN):
        if dtype == torch.int8:
            xn = ((xn.astype(np.int64) @ wn.astype(np.int64)) & 1).astype(np.float32)
        else:
            xn = _bf16((xn @ wn) * np.float32(1e-3))
    if dtype == torch.int8:
        np.testing.assert_array_equal(got, xn)
    else:
        np.testing.assert_allclose(got, xn, rtol=TOL, atol=TOL)


def test_qblock_part_rejects_bad_operands():
    x, _, (tw1, tw2), _ = _int8_case(15, sparse=False)
    tx = torch.from_numpy(x)
    with pytest.raises(ValueError, match="variant"):
        port_qparts.qblock_part("dotrate", tx, tw1, tw2)
    with pytest.raises(TypeError, match="bf16gemm"):
        port_qparts.qblock_part("bf16gemm", tx, tw1, tw2)
    with pytest.raises(ValueError, match="not divisible"):
        port_qparts.qblock_part("convs", tx, tw1, tw2, batch_tile=48)
    with pytest.raises(ValueError, match="wq2"):
        port_qparts.qblock_part("novpu", tx, tw1, tw2[:, :, :8])
    with pytest.raises(ValueError, match="768"):
        port_qparts.dot_chain(tx.reshape(-1, 32), tw1.reshape(-1, 32), 1)

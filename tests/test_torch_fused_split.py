"""What the CPU can hold of the padded input conv and of the fused block's
four-kernel split: the routes (pure functions of the shapes), that zero
channels change nothing, that the fused forward with its planes padded to 64
still equals the JAX fused forward, the block's launch plan, and that the
ctypes signature table matches the C entry points the sources declare. The
kernels themselves run in tests/test_torch_cuda.py.

Tolerances: a conv on zero-padded channels is the same exact sum, so on
small-integer inputs (every partial sum exact in f32) it must be equal, and
on random inputs within 1e-6 of max |ref| (an f32 sum whose order the CPU
GEMM may choose by K); against the interpreted Pallas kernel rtol = atol =
0.05 (bf16 outputs, the TestPallasConv bound); the forwards at the
TestFusedForward bounds, as tests/test_torch_models.py.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keisei_tpu.models.fused_infer import make_fused_forward as jax_make_fused_forward
from keisei_tpu.models.registry import build_model as jax_build_model
from keisei_tpu.ops.conv3x3 import conv3x3_hwbc as jax_conv3x3
from keisei_tpu_torch.models.convert import flax_to_torch
from keisei_tpu_torch.models.fused_infer import make_fused_forward, make_quantized_forward
from keisei_tpu_torch.models.registry import build_model
from keisei_tpu_torch.ops import _build, conv3x3, fused_block
from keisei_tpu_torch.ops.conv3x3 import (conv3x3_hwbc, conv3x3_hwbc_reference, conv3x3_taps_f32,
                                          conv_route, pad_channels, padded_channels, wgmma_tile)
from keisei_tpu_torch.ops.fused_block import POOL_4_FROM, block_plan
from keisei_tpu_torch.utils.timing import TRACE_LEAD, traced_kernel_ms

torch.set_num_threads(2)
TOL = 0.05
TINY = {"num_blocks": 2, "channels": 32, "global_pool_channels": 16, "se_reduction": 4}


@pytest.mark.parametrize("cout", [128, 256])
@pytest.mark.parametrize("cin", [46, 50, 64, 100])
def test_conv_route_pads_what_tma_cannot_address(cin, cout):
    """Cin % 64 != 0 takes the wgmma kernel after a pad, on the tile the
    padded shape takes; never the mma.sync kernel."""
    for n in (1, 64, 256, 1024):
        route = conv_route(n, cin, cout)
        assert route.kernel == ("wgmma" if cin % 64 == 0 else "wgmma_padded")
        assert route[1:] == wgmma_tile(n, cout)[1:] == conv_route(n, padded_channels(cin), cout)[1:]
    assert padded_channels(cin) == {46: 64, 50: 64, 64: 64, 100: 128}[cin]


@pytest.mark.parametrize("cin,cout,b", [(50, 32, 8), (46, 16, 5), (100, 8, 3)])
def test_padded_conv_equals_unpadded(cin, cout, b):
    rng = np.random.default_rng(cin)
    ints = (torch.from_numpy(rng.integers(-3, 4, size=(9, 9, b, cin)).astype(np.float32)),
            torch.from_numpy(rng.integers(-3, 4, size=(3, 3, cin, cout)).astype(np.float32)))
    reals = (torch.from_numpy(rng.normal(size=(9, 9, b, cin)).astype(np.float32)),
             torch.from_numpy((rng.normal(size=(3, 3, cin, cout)) / np.sqrt(9 * cin))
                              .astype(np.float32)))
    for (x, w), exact in ((ints, True), (reals, False)):
        x, w = x.to(torch.bfloat16), w.to(torch.bfloat16)
        xp, wp = pad_channels(x, 3), pad_channels(w, 2)
        assert xp.shape == (9, 9, b, padded_channels(cin)) and xp.is_contiguous()
        assert wp.shape == (3, 3, padded_channels(cin), cout) and wp.is_contiguous()
        assert torch.equal(xp[..., :cin], x) and not xp[..., cin:].any()
        assert torch.equal(wp[:, :, :cin], w) and not wp[:, :, cin:].any()
        ref, got = conv3x3_taps_f32(x, w), conv3x3_taps_f32(xp, wp)
        if exact:
            assert torch.equal(got, ref)
            assert torch.equal(conv3x3_hwbc(xp, wp), conv3x3_hwbc_reference(x, w))
        else:
            assert float((got - ref).abs().max()) <= 1e-6 * float(ref.abs().max())


def test_padded_conv_matches_pallas_at_50_planes():
    rng = np.random.default_rng(50)
    x = rng.normal(size=(9, 9, 8, 50)).astype(np.float32)
    w = (rng.normal(size=(3, 3, 50, 32)) / np.sqrt(450)).astype(np.float32)
    tx, tw = torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(w).to(torch.bfloat16)
    conv3x3_hwbc.launches = 0
    conv3x3_hwbc.route_launches.clear()
    got = conv3x3_hwbc(pad_channels(tx, 3), pad_channels(tw, 2))
    assert conv3x3_hwbc.launches == 0 and not conv3x3_hwbc.route_launches
    ref = jax_conv3x3(jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(w).astype(jnp.bfloat16),
                      batch_tile=8, interpret=True)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref.astype(jnp.float32)),
                               rtol=TOL, atol=TOL)


def _variables(model, planes, seed):
    variables = jax.device_get(
        model.init(jax.random.key(seed), jnp.zeros((2, planes, 9, 9), jnp.float32), train=False))
    rng = np.random.default_rng(seed)

    def perturb(path, a):
        name = path[-1].key
        if name == "var":
            return np.exp(rng.normal(size=a.shape) * 0.2).astype(np.float32)
        if name == "mean":
            return (rng.normal(size=a.shape) * 0.1).astype(np.float32)
        return np.asarray(a)

    stats = jax.tree_util.tree_map_with_path(perturb, variables["batch_stats"])
    return {"params": jax.tree.map(np.asarray, variables["params"]), "batch_stats": stats}


@pytest.mark.parametrize("planes", [50, 46])
def test_fused_forward_with_padded_stem_matches_jax(planes):
    params = {**TINY, "obs_channels": planes}
    jmodel, jcfg = jax_build_model("se_resnet", params)
    variables = _variables(jmodel, planes, seed=planes)
    tmodel, cfg = build_model("se_resnet", params)
    tmodel.load_state_dict(flax_to_torch(variables["params"], variables["batch_stats"]))
    batch = 8
    obs = (np.random.default_rng(planes + 1).normal(size=(batch, planes, 9, 9)) > 0.8
           ).astype(np.float32)

    fwd = make_fused_forward(cfg)
    weights = fwd.prepare(tmodel)
    hwio = tmodel.input_conv.weight.permute(2, 3, 1, 0).to(torch.bfloat16)
    assert weights.input_w.shape == (3, 3, 64, TINY["channels"]) and weights.input_w.is_contiguous()
    assert torch.equal(weights.input_w[:, :, :planes], hwio)
    assert not weights.input_w[:, :, planes:].any()
    assert torch.equal(make_quantized_forward(cfg).prepare(tmodel).input_w, weights.input_w)

    ref = jax_make_fused_forward(jcfg, batch_tile=8, interpret=True)(
        jax.tree.map(jnp.asarray, variables), jnp.asarray(obs))
    conv3x3.conv3x3_hwbc.launches = fused_block.fused_gpbias_block.launches = 0
    with torch.no_grad():
        got = fwd(weights, torch.from_numpy(obs))
    assert conv3x3.conv3x3_hwbc.launches == 0 and fused_block.fused_gpbias_block.launches == 0
    gp, rp = got.policy_logits.numpy(), np.asarray(ref.policy_logits)
    np.testing.assert_allclose(gp, rp, rtol=0.1, atol=0.15)
    np.testing.assert_allclose(got.value_logits.numpy(), np.asarray(ref.value_logits),
                               rtol=0.1, atol=0.1)
    np.testing.assert_allclose(got.score_lead.numpy(), np.asarray(ref.score_lead),
                               rtol=0.1, atol=0.1)
    agree = (gp.reshape(batch, -1).argmax(1) == rp.reshape(batch, -1).argmax(1)).mean()
    assert agree >= 0.7, f"top-1 agreement {agree}"
    with pytest.raises(ValueError, match="expected obs"):
        fwd(weights, torch.zeros(batch, planes + 1, 9, 9))


# (n, c) -> conv tile height, pool boards per CTA
PLANS = {
    (1, 128): (64, 1), (1, 256): (64, 1), (31, 128): (64, 1), (31, 256): (64, 1),
    (64, 128): (64, 1), (64, 256): (64, 1), (65, 128): (64, 1), (65, 256): (64, 1),
    (256, 128): (128, 1), (256, 256): (64, 1), (1024, 128): (128, 4), (1024, 256): (128, 4),
}


@pytest.mark.parametrize("n,c", list(PLANS))
def test_block_plan(n, c):
    plan = block_plan(n, c)
    boards, pool_boards = PLANS[(n, c)]
    assert plan.tile == wgmma_tile(n, c) and plan.tile.cout_tile == c and plan.tile.persistent
    assert (plan.tile.boards, plan.pool_boards) == (boards, pool_boards)
    # scratch: g2 (n, c) f32, h (9, 9, n, c) bf16, z (9, 9, n, c) f32, each 16-byte aligned
    # when laid end to end
    assert (plan.g2_bytes, plan.h_bytes, plan.z_bytes) == (4 * n * c, 162 * n * c, 324 * n * c)
    assert plan.scratch_bytes == 490 * n * c
    assert plan.g2_bytes % 16 == 0 and (plan.g2_bytes + plan.h_bytes) % 16 == 0
    # the pool kernel's boards per CTA can be fixed; nothing else follows it
    for fixed in (1, 4):
        assert block_plan(n, c, fixed) == plan._replace(pool_boards=fixed)
    assert block_plan(POOL_4_FROM - 1, c).pool_boards == 1
    assert block_plan(POOL_4_FROM, c).pool_boards == 4


def test_block_plan_refuses_other_widths():
    for c in (64, 192, 512):
        with pytest.raises(ValueError, match="C in"):
            block_plan(64, c)
    with pytest.raises(ValueError, match="at least one board"):
        block_plan(0, 256)
    with pytest.raises(ValueError, match="pool_boards"):
        block_plan(64, 256, pool_boards=2)


def _c_entries():
    """name -> ctypes argument list, read off the `extern "C"` definitions in
    csrc/*.cu: a pointer parameter is a c_void_p, an int a c_int, a float a
    c_float."""
    entries = {}
    for src in sorted(_build.CSRC.glob("*.cu")):
        for name, params in re.findall(r"^int (keisei_\w+)\(([^)]*)\)\s*\{", src.read_text(),
                                       flags=re.M):
            assert name not in entries, f"{name} defined twice"
            entries[name] = [_build._P if "*" in p else
                             _build._F if re.match(r"\s*float \w+$", p) else _build._I
                             for p in params.split(",")]
            assert all("*" in p or re.match(r"\s*(int|float) \w+$", p)
                       for p in params.split(",")), params
    return entries


@pytest.mark.parametrize("name", list(_build.SIGNATURES))
def test_signature_table_matches_the_c_entry(name):
    assert _build.SIGNATURES[name] == _c_entries()[name]


def test_signature_table_names_every_entry_the_wrappers_call():
    called = set()
    root = _build.CSRC.parent
    for py in [*root.glob("ops/*.py"), *root.glob("scripts/*.py")]:
        called |= set(re.findall(r"\blib\.(keisei_\w+)\(", py.read_text()))
    called.discard("keisei_cuda_error_string")  # bound by load_library itself: it returns a string
    assert called and called <= set(_build.SIGNATURES), called - set(_build.SIGNATURES)
    assert set(_c_entries()) == set(_build.SIGNATURES)


def test_traced_kernel_ms_reads_the_trace_from_its_end():
    """The mean is over exactly the last calls * per_call launches of a
    trace made by trace_kernel_us(fn, calls); fewer in the trace, more than
    were made, or two kernels under one pattern raise."""
    lost = [9.0] * (2 * TRACE_LEAD - 3)        # the lead calls' launches, 3 of them lost
    trace = {"void k<1>(int)": [*lost, 1.0, 2.0, 3.0, 6.0], "other": [5.0]}
    ms, seen = traced_kernel_ms(trace, r"k<1>", calls=2, per_call=2)
    assert ms == pytest.approx(0.003) and seen == len(lost) + 4
    assert traced_kernel_ms(trace, r"other", calls=1) == (pytest.approx(0.005), 1)
    with pytest.raises(RuntimeError, match="holds 1 launches"):
        traced_kernel_ms(trace, r"other", calls=2)
    with pytest.raises(RuntimeError, match="holds 0 launches"):
        traced_kernel_ms(trace, r"missing", calls=1)
    with pytest.raises(RuntimeError, match=f"holds {len(lost) + 4} launches"):
        traced_kernel_ms(trace, r"k<1>", calls=2)      # more than TRACE_LEAD + 2 were not made
    with pytest.raises(RuntimeError, match="more than one"):
        traced_kernel_ms(trace, r"k|other", calls=1)

"""The tensor-core rate probe's function (row 4 of PERF.md's kernel table)
against the TPU kernel it replaces, on the CPU.

scripts/profile_int8_mxu.py stays as it is. Its module-level kernel bodies
`_kernel_int8` / `_kernel_bf16` run inside a copy of its `pallas_call` spec
(both operands and the output whole in VMEM) with interpret=True, at a
small (M, K) and the module's CHAIN patched to 3. The script calls
ensure_compile_cache() when it is imported, so JAX_COMPILATION_CACHE_DIR
points at a temporary directory first and nothing is written under HOME.

The port's `mma_chain` takes B as B^T ([n][k]), so it gets b.T of the
TPU's operand. Inputs from a numpy seed: X in {0, 1}, B in {-1, 0, 1}, and
for bf16 B scaled by 1/8. Tolerance: int8 exact (parity bits of exact
sums); bf16 rtol = atol = 0.05 (the dot chain's TOL; both sides round the
same f32 sums times 1e-3 to bf16 once per step, in another summation
order), and, because the chain shrinks the values by ~1e-3 a step, the
same 0.05 again with atol relative to the largest |value|.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from keisei_tpu_torch.ops.gemm_chain import WHOLE_BF16, chain_plan, gemm_chain, hold_to_plain
from keisei_tpu_torch.scripts import profile_int8_mma as port_probe

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]
TOL = 0.05


@pytest.fixture
def mxu(monkeypatch, tmp_path):
    """scripts/profile_int8_mxu.py, imported with its compile cache in
    tmp_path; its CHAIN is read before the test patches it."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    spec = importlib.util.spec_from_file_location("_tpu_script_profile_int8_mxu",
                                                  REPO / "scripts" / "profile_int8_mxu.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert not any(tmp_path.iterdir())
    return mod


def _interpreted(mod, x: np.ndarray, b: np.ndarray, int8: bool) -> np.ndarray:
    """profile_int8_mxu.py:make's pallas_call (:75-81) around its kernel
    body, interpreted, at x's shape."""
    dt = jnp.int8 if int8 else jnp.bfloat16
    kern = mod._kernel_int8 if int8 else mod._kernel_bf16
    out = pl.pallas_call(
        kern,
        out_shape=jax.ShapeDtypeStruct(x.shape, jnp.int32 if int8 else jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM), pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True,
    )(jnp.asarray(x).astype(dt), jnp.asarray(b).astype(dt))
    return np.asarray(out)


def _case(m: int, k: int, int8: bool, seed: int):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 2, size=(m, k)).astype(np.float32)
    b = rng.integers(-1, 2, size=(k, k)).astype(np.float32)
    if not int8:
        b = b / 8
    dt = torch.int8 if int8 else torch.bfloat16
    return x, b, torch.from_numpy(x).to(dt), torch.from_numpy(np.ascontiguousarray(b.T)).to(dt)


@pytest.mark.parametrize("m,k", [(64, 128), (40, 192)])
@pytest.mark.parametrize("int8", [True, False], ids=["int8", "bf16"])
def test_mma_chain_matches_interpreted_kernel(mxu, monkeypatch, int8, m, k):
    monkeypatch.setattr(mxu, "CHAIN", 3)
    x, b, tx, tbt = _case(m, k, int8, seed=k + int8)
    ref = _interpreted(mxu, x, b, int8)
    port_probe.mma_chain.launches.clear()
    got = port_probe.mma_chain(tx, tbt, 3)
    assert not port_probe.mma_chain.launches
    assert got.shape == (m, k) and got.dtype == tx.dtype
    got = got.float().numpy()
    if int8:
        assert set(np.unique(ref)) <= {0, 1}
        np.testing.assert_array_equal(got, ref)
    else:
        scale = float(np.abs(ref).max())
        assert scale > 0
        np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL * scale)


def test_probe_constants_follow_the_tpu_script(mxu):
    """K = 512 and CHAIN = 32 per launch, as profile_int8_mxu.py has them;
    M fills whole waves of clusters of both types on 132 SMs."""
    assert (port_probe.K, port_probe.CHAIN) == (mxu.K, mxu.CHAIN) == (512, 32)
    for dtype in (torch.int8, torch.bfloat16):
        plan = chain_plan(dtype, port_probe.K)
        clusters_per_wave = 132 // plan.cn
        assert port_probe.M % (clusters_per_wave * plan.rows) == 0


@pytest.mark.parametrize("k", [64, 256, 512, 768])
def test_mma_chain_takes_any_k_of_64s_on_cpu(k):
    """On CPU tensors any K that is a multiple of 64 runs the plain version,
    the card's plans or not; other shapes raise."""
    a, b = port_probe.probe_inputs(torch.int8, 16, "cpu", k=k)
    x = a.numpy().astype(np.int64)
    for _ in range(2):
        x = (x @ b.numpy().astype(np.int64).T) & 1
    np.testing.assert_array_equal(port_probe.mma_chain(a, b, 2).numpy(), x)


def test_mma_chain_rejects_bad_operands():
    a, b = port_probe.probe_inputs(torch.int8, 16, "cpu", k=64)
    with pytest.raises(ValueError, match="multiple of 64"):
        port_probe.mma_chain(a[:, :48], b[:48, :48], 1)
    with pytest.raises(ValueError, match="wt"):
        port_probe.mma_chain(a, b[:, :32], 1)
    with pytest.raises(TypeError, match="int8 or bfloat16"):
        port_probe.mma_chain(a.float(), b.float(), 1)
    with pytest.raises(ValueError, match="chain"):
        port_probe.mma_chain(a, b, 0)
    # the card's kernel takes (type, K) in its plans only: refused before any launch
    with pytest.raises(ValueError, match="takes \\(type, K\\)"):
        chain_plan(torch.int8, 256)
    with pytest.raises(ValueError, match="unsupported device"):
        gemm_chain(a.to("meta"), b.to("meta"), 1)


@pytest.mark.parametrize("chain", [3, 12])
@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
def test_hold_to_plain_passes_the_plain_chain_and_catches_a_bad_step(dtype, chain):
    """The card's bound (hold_to_plain), driven here by the plain version:
    it passes the plain chain and refuses one whose step n is off."""
    a, b = port_probe.probe_inputs(dtype, 16, "cpu", k=64)
    res = hold_to_plain(gemm_chain, a, b, chain)
    assert res["max_abs_err"] == 0 and res.get("step_err", 0) == 0
    assert ("step_err" in res) == (dtype == torch.bfloat16 and chain > WHOLE_BF16)

    def off_at(n_bad):
        def fn(x, wt, n):
            y = gemm_chain(x, wt, n)
            if n >= n_bad:  # every launch from step n_bad on carries the fault
                y = (1 - y) if dtype == torch.int8 else y * 2
            return y
        return fn

    for n_bad in (1, chain):
        with pytest.raises(AssertionError, match="differs|disagrees"):
            hold_to_plain(off_at(n_bad), a, b, chain)


@pytest.mark.parametrize("chain", [WHOLE_BF16 + 1, 12])
def test_hold_to_plain_catches_a_chain_whose_prefix_is_not_the_shorter_chain(chain):
    """A bf16 fn whose every step is within the bound of one plain step but
    whose even-length chains end 0.03 off in one element: step n of
    fn(x, n) is not what one launch of a step from fn(x, n - 1) gives, and
    hold_to_plain refuses it."""
    a, b = port_probe.probe_inputs(torch.bfloat16, 16, "cpu", k=64)

    def fn(x, wt, n):
        y = gemm_chain(x, wt, n)
        if n % 2 == 0:
            y = y.clone()
            y[0, 0] = y[0, 0].float() + 0.03  # within atol of the plain step, a bf16 ulp or more
        return y

    assert not torch.equal(fn(a, b, 2), gemm_chain(a, b, 2))
    with pytest.raises(AssertionError, match="prefix"):
        hold_to_plain(fn, a, b, chain)

"""The port's SE-ResNet (eager and fused forward) against the flax model.

Both packages get the same weights: flax initialises them from a seed,
batch statistics are perturbed with numpy so the BatchNorm fold is not the
identity, and models/convert.py carries them into the torch model.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keisei_tpu.models.fused_infer import make_fused_forward as jax_make_fused_forward
from keisei_tpu.models.fused_infer import make_quantized_forward as jax_make_quantized_forward
from keisei_tpu.models.registry import build_model as jax_build_model
from keisei_tpu_torch.models.convert import flax_to_torch
from keisei_tpu_torch.models.fused_infer import make_fused_forward, make_quantized_forward
from keisei_tpu_torch.models.registry import build_model
from keisei_tpu_torch.ops import conv3x3, fused_block, qblock

torch.set_num_threads(2)

TINY = {"num_blocks": 2, "channels": 32, "global_pool_channels": 16, "se_reduction": 4}


def _perturbed_variables(model, seed):
    variables = jax.device_get(
        model.init(jax.random.key(seed), jnp.zeros((2, 50, 9, 9), jnp.float32), train=False))
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


@pytest.fixture(scope="module")
def f32_pair():
    jmodel, _ = jax_build_model("se_resnet", {**TINY, "dtype": jnp.float32})
    variables = _perturbed_variables(jmodel, 0)
    tmodel, _ = build_model("se_resnet", {**TINY, "dtype": "float32"})
    tmodel.load_state_dict(flax_to_torch(variables["params"], variables["batch_stats"]))
    return jmodel, tmodel, variables


def _obs(batch, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(batch, 50, 9, 9)) > 0.8).astype(np.float32)


def test_eval_forward_matches_flax_f32(f32_pair):
    """rtol 1e-4: both sides run float32; only summation order differs."""
    jmodel, tmodel, variables = f32_pair
    obs = _obs(6, 1)
    ref = jmodel.apply(variables, jnp.asarray(obs), train=False)
    tmodel.eval()
    with torch.no_grad():
        got = tmodel(torch.from_numpy(obs))
    for name in ("policy_logits", "value_logits", "score_lead"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=1e-4, atol=1e-4, err_msg=name)


def test_train_forward_and_bn_update_match_flax_f32(f32_pair):
    """Train mode: batch statistics in the forward and the running-stat
    update (flax momentum 0.9, biased variance). rtol 1e-4, float32."""
    jmodel, _, variables = f32_pair
    tmodel, _ = build_model("se_resnet", {**TINY, "dtype": "float32"})
    tmodel.load_state_dict(flax_to_torch(variables["params"], variables["batch_stats"]))
    obs = _obs(6, 2)
    ref, upd = jmodel.apply(variables, jnp.asarray(obs), train=True, mutable=["batch_stats"])
    tmodel.train()
    with torch.no_grad():
        got = tmodel(torch.from_numpy(obs))
    for name in ("policy_logits", "value_logits", "score_lead"):
        np.testing.assert_allclose(getattr(got, name).numpy(), np.asarray(getattr(ref, name)),
                                   rtol=1e-4, atol=1e-4, err_msg=name)
    want = flax_to_torch(variables["params"], jax.device_get(upd["batch_stats"]))
    sd = tmodel.state_dict()
    for k, v in want.items():
        if "running" in k:
            np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=1e-4, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("batch", [8, 16])
def test_fused_forward_matches_jax_fused(batch):
    """bf16 model: the port's fused forward (plain kernel versions on the
    CPU) against JAX's make_fused_forward(interpret=True), with the
    TestFusedForward tolerances (bf16 rounding placed slightly differently
    by each framework): policy rtol 0.1 / atol 0.15, value and score 0.1,
    top-1 agreement >= 0.7."""
    jmodel, jcfg = jax_build_model("se_resnet", TINY)
    variables = _perturbed_variables(jmodel, 3)
    tmodel, cfg = build_model("se_resnet", TINY)
    tmodel.load_state_dict(flax_to_torch(variables["params"], variables["batch_stats"]))
    obs = _obs(batch, 4)

    ref = jax_make_fused_forward(jcfg, batch_tile=8, interpret=True)(
        jax.tree.map(jnp.asarray, variables), jnp.asarray(obs))
    conv3x3.conv3x3_hwbc.launches = fused_block.fused_gpbias_block.launches = 0
    fwd = make_fused_forward(cfg)
    with torch.no_grad():
        got = fwd(fwd.prepare(tmodel), torch.from_numpy(obs))
    assert conv3x3.conv3x3_hwbc.launches == 0 and fused_block.fused_gpbias_block.launches == 0

    gp = got.policy_logits.numpy()
    rp = np.asarray(ref.policy_logits)
    np.testing.assert_allclose(gp, rp, rtol=0.1, atol=0.15)
    np.testing.assert_allclose(got.value_logits.numpy(), np.asarray(ref.value_logits),
                               rtol=0.1, atol=0.1)
    np.testing.assert_allclose(got.score_lead.numpy(), np.asarray(ref.score_lead),
                               rtol=0.1, atol=0.1)
    agree = (gp.reshape(batch, -1).argmax(1) == rp.reshape(batch, -1).argmax(1)).mean()
    assert agree >= 0.7, f"top-1 agreement {agree}"


def test_fused_forward_matches_eager_bf16():
    """The port's fused forward against its own eager bf16 eval forward,
    the same comparison chip_smoke.py makes on the card (same tolerances)."""
    tmodel, cfg = build_model("se_resnet", TINY)
    tmodel.eval()
    obs = torch.from_numpy(_obs(8, 5))
    fwd = make_fused_forward(cfg)
    with torch.no_grad():
        got = fwd(fwd.prepare(tmodel), obs)
        ref = tmodel(obs)
    np.testing.assert_allclose(got.policy_logits.numpy(), ref.policy_logits.numpy(),
                               rtol=0.1, atol=0.15)
    np.testing.assert_allclose(got.value_logits.numpy(), ref.value_logits.numpy(),
                               rtol=0.1, atol=0.1)


@pytest.mark.parametrize("batch", [32, 64])
def test_quantized_forward_matches_jax_quantized(batch):
    """The port's int8 forward (plain block on the CPU) against JAX's
    make_quantized_forward(interpret=True) on the same weights. Both
    quantize identically; only one-level rounding flips from f32 sums taken
    in another order differ (measured here: policy within 0.03). Held to the
    TestFusedForward tolerances: policy rtol 0.1 / atol 0.15, value and
    score 0.1, top-1 agreement >= 0.7."""
    jmodel, jcfg = jax_build_model("se_resnet", TINY)
    variables = _perturbed_variables(jmodel, 5)
    tmodel, cfg = build_model("se_resnet", TINY)
    tmodel.load_state_dict(flax_to_torch(variables["params"], variables["batch_stats"]))
    obs = _obs(batch, 6)

    ref = jax_make_quantized_forward(jcfg, interpret=True)(
        jax.tree.map(jnp.asarray, variables), jnp.asarray(obs))
    qblock.quantized_gpbias_block.launches = 0
    fwd = make_quantized_forward(cfg)
    got = fwd(fwd.prepare(tmodel), torch.from_numpy(obs))
    assert qblock.quantized_gpbias_block.launches == 0

    gp, rp = got.policy_logits.numpy(), np.asarray(ref.policy_logits)
    np.testing.assert_allclose(gp, rp, rtol=0.1, atol=0.15)
    np.testing.assert_allclose(got.value_logits.numpy(), np.asarray(ref.value_logits),
                               rtol=0.1, atol=0.1)
    np.testing.assert_allclose(got.score_lead.numpy(), np.asarray(ref.score_lead),
                               rtol=0.1, atol=0.1)
    agree = (gp.reshape(batch, -1).argmax(1) == rp.reshape(batch, -1).argmax(1)).mean()
    assert agree >= 0.7, f"top-1 agreement {agree}"


@pytest.mark.parametrize("batch", [32, 64])
def test_quantized_forward_close_to_f32_truth(batch):
    """TestQuantizedForward's own criterion, on the port: the int8 forward
    against the eager f32 model, with the eager bf16 model's error as the
    yardstick: q_err < max(5 bf_err, 0.08), top-1 >= 0.8, value error
    < 0.1 of the value scale. C=128, 2 blocks, as that test."""
    params = {"num_blocks": 2, "channels": 128, "global_pool_channels": 64}
    jmodel, _ = jax_build_model("se_resnet", params)
    variables = _perturbed_variables(jmodel, 7)
    sd = flax_to_torch(variables["params"], variables["batch_stats"])
    f32_model, _ = build_model("se_resnet", {**params, "dtype": "float32"})
    bf16_model, cfg = build_model("se_resnet", params)
    for m in (f32_model, bf16_model):
        m.load_state_dict(sd)
        m.eval()
    obs = torch.from_numpy(_obs(batch, 21))
    fwd = make_quantized_forward(cfg)
    with torch.no_grad():
        truth, bf16_ref = f32_model(obs), bf16_model(obs)
        got = fwd(fwd.prepare(bf16_model), obs)

    t = truth.policy_logits.reshape(batch, -1).numpy()
    q = got.policy_logits.reshape(batch, -1).numpy()
    r = bf16_ref.policy_logits.reshape(batch, -1).float().numpy()
    scale = np.abs(t).max()
    q_err, bf_err = np.abs(q - t).max() / scale, np.abs(r - t).max() / scale
    assert q_err < max(5 * bf_err, 0.08), (q_err, bf_err)
    assert (q.argmax(1) == t.argmax(1)).mean() >= 0.8
    v_err = np.abs(got.value_logits.numpy() - truth.value_logits.numpy()).max()
    assert v_err / (np.abs(truth.value_logits.numpy()).max() + 1e-9) < 0.1, v_err


def test_quantized_forward_rejects_batches_without_a_tile():
    tmodel, cfg = build_model("se_resnet", TINY)
    fwd = make_quantized_forward(cfg)
    with pytest.raises(ValueError, match="divisible by 32"):
        fwd(fwd.prepare(tmodel), torch.zeros(40, 50, 9, 9))


def test_registry_rejects_unported_architecture():
    with pytest.raises(NotImplementedError, match="not yet ported"):
        build_model("resnet", {})
    with pytest.raises(ValueError, match="unknown model params"):
        build_model("se_resnet", {"bogus": 1})

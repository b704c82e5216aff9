"""The port's training core against the JAX package: GAE and its overrides,
value categories, masked log-softmax / entropy, the entropy schedule, and
one full PPO update fed the same trajectory and the same minibatches."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keisei_tpu.models.registry import build_model as jax_build_model
from keisei_tpu.training import gae as JG
from keisei_tpu.training import ppo as JP
from keisei_tpu.training.value_adapter import MultiHeadValueAdapter as JaxAdapter
from keisei_tpu_torch.models.convert import flax_to_torch
from keisei_tpu_torch.models.registry import build_model
from keisei_tpu_torch.training import gae as G
from keisei_tpu_torch.training import ppo as P
from keisei_tpu_torch.training.value_adapter import get_value_adapter

torch.set_num_threads(2)


def _gae_inputs(seed, T=12, N=6):
    rng = np.random.default_rng(seed)
    term = rng.random((T, N)) < 0.15
    trunc = (rng.random((T, N)) < 0.1) & ~term
    rewards = np.where(term, rng.choice([-1.0, 0.0, 1.0], size=(T, N)), 0.0).astype(np.float32)
    values = rng.uniform(-1, 1, (T, N)).astype(np.float32)
    ov = np.where(trunc, rng.uniform(-1, 1, (T, N)), np.nan).astype(np.float32)
    nv = rng.uniform(-1, 1, N).astype(np.float32)
    return rewards, values, term, term | trunc, ov, nv


@pytest.mark.parametrize("alternating", [False, True])
def test_gae_matches_jax(alternating):
    """f32 on both sides, the same recurrence: rtol 1e-6."""
    rewards, values, term, dones, ov, nv = _gae_inputs(0)
    ov_full = np.asarray(JG.alternating_perspective_overrides(
        jnp.asarray(values), jnp.asarray(term), jnp.asarray(ov)))
    got_ov = G.alternating_perspective_overrides(
        torch.from_numpy(values), torch.from_numpy(term), torch.from_numpy(ov))
    np.testing.assert_array_equal(got_ov.numpy(), ov_full)  # NaNs in the same cells

    ref = JG.compute_gae(jnp.asarray(rewards), jnp.asarray(values), jnp.asarray(term),
                         jnp.asarray(nv), 0.99, 0.95, jnp.asarray(ov_full),
                         chain_cut=jnp.asarray(dones), alternating=alternating)
    got = G.compute_gae(torch.from_numpy(rewards), torch.from_numpy(values),
                        torch.from_numpy(term), torch.from_numpy(nv), 0.99, 0.95,
                        got_ov, chain_cut=torch.from_numpy(dones), alternating=alternating)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-6)


def test_value_cats_log_softmax_entropy_match_jax():
    rng = np.random.default_rng(1)
    rewards = rng.choice([-1.0, 0.0, 1.0], size=20).astype(np.float32)
    term = rng.random(20) < 0.5
    np.testing.assert_array_equal(
        P.compute_value_cats(torch.from_numpy(rewards), torch.from_numpy(term)).numpy(),
        np.asarray(JP.compute_value_cats(jnp.asarray(rewards), jnp.asarray(term))))

    logits = rng.normal(size=(4, 300)).astype(np.float32) * 3
    mask = rng.random((4, 300)) < 0.1
    mask[:, 0] = True
    ref = np.asarray(JP.masked_log_softmax(jnp.asarray(logits), jnp.asarray(mask)))
    got = P.masked_log_softmax(torch.from_numpy(logits), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)  # f32 log-softmax
    ent = lambda lp: -(np.exp(lp) * np.where(mask, lp, 0.0)).sum(-1)  # noqa: E731
    np.testing.assert_allclose(ent(got), ent(ref), rtol=1e-5)


def test_entropy_schedule_matches_jax():
    jcfg = JP.KataGoPPOParams(lambda_entropy=0.01, entropy_decay_epochs=10)
    tcfg = P.KataGoPPOParams(lambda_entropy=0.01, entropy_decay_epochs=10)
    for epoch in range(0, 20, 3):
        for warm in (0, 4):
            assert P.entropy_coeff_schedule(tcfg, epoch, warm, 0.02) == \
                JP.entropy_coeff_schedule(jcfg, epoch, warm, 0.02)


def test_ppo_params_validation():
    with pytest.raises(ValueError, match="batch_size"):
        P.KataGoPPOParams(batch_size=0)
    with pytest.raises(ValueError, match="grad_clip"):
        P.KataGoPPOParams(grad_clip=0.0)


TINY = {"num_blocks": 1, "channels": 16, "global_pool_channels": 8, "se_reduction": 4}


def _trajectory(seed, T=4, N=8, C=50):
    rng = np.random.default_rng(seed)
    A = 81 * 139
    masks = rng.random((T, N, A)) < 0.02
    actions = np.zeros((T, N), np.int32)
    for t in range(T):
        for n in range(N):
            legal = np.flatnonzero(masks[t, n])
            actions[t, n] = rng.choice(legal)
    rewards, values, term, dones, ov, nv = _gae_inputs(seed, T, N)
    return {
        "obs": (rng.random((T, N, C, 81)) < 0.2).astype(np.float32),
        "actions": actions,
        "log_probs": (-np.log(masks.sum(-1)) + rng.normal(size=(T, N)) * 0.1).astype(np.float32),
        "values": values, "rewards": rewards, "dones": dones, "terminated": term,
        "legal_masks": masks,
        "value_cats": np.where(term, np.where(rewards > 0, 0, np.where(rewards < 0, 2, 1)),
                               -1).astype(np.int32),
        "score_targets": (rng.normal(size=(T, N)) * 0.1).astype(np.float32),
        "next_value_override": ov,
    }, nv


def test_ppo_update_matches_jax():
    """One update (2 epochs x 2 minibatches) on f32 models with the same
    weights, trajectory and per-epoch permutations (recomputed from the JAX
    update's key). Tolerance rtol 1e-3: float32 throughout; the differences
    are summation order in convs and reductions, carried through four Adam
    steps. atol 2e-6 covers parameters that start at 0 (biases)."""
    jmodel, _ = jax_build_model("se_resnet", {**TINY, "dtype": jnp.float32})
    variables = jax.device_get(jmodel.init(jax.random.key(0), jnp.zeros((2, 50, 9, 9)),
                                           train=False))
    cfg_kw = dict(batch_size=16, epochs_per_batch=2, learning_rate=2e-4, lambda_score=0.1,
                  score_blend_alpha=0.1)
    jcfg = JP.KataGoPPOParams(**cfg_kw)
    tcfg = P.KataGoPPOParams(**cfg_kw)
    jadapter = JaxAdapter(lambda_value=1.5, lambda_score=0.1, score_blend_alpha=0.1)
    tadapter = get_value_adapter("katago", lambda_value=1.5, lambda_score=0.1,
                                 score_blend_alpha=0.1)

    data, nv = _trajectory(3)
    jopt = JP.make_optimizer(jcfg)
    state = JP.TrainState(params=variables["params"], batch_stats=variables["batch_stats"],
                          opt_state=jopt.init(variables["params"]), step=jnp.int32(0))
    jtraj = JP.Trajectory(**{k: jnp.asarray(v) for k, v in data.items()})
    key = jax.random.key(5)
    # op by op: XLA's fused CPU program takes the value-loss gradient through
    # the pool's sqrt(var + 1e-10) (ill-conditioned for near-constant
    # channels) ~2% away from both eager JAX and torch, which agree to 1e-6
    with jax.disable_jit():
        new_state, jm = JP.make_ppo_update(jmodel, jadapter, jcfg, jopt)(
            state, jtraj, jnp.asarray(nv), key, 0.01)

    S = data["rewards"].size
    perms, rng = [], key
    for _ in range(jcfg.epochs_per_batch):
        rng, k = jax.random.split(rng)
        perms.append(torch.from_numpy(np.asarray(jax.random.permutation(k, S)).astype(np.int64)))

    tmodel, _ = build_model("se_resnet", {**TINY, "dtype": "float32"})
    tmodel.load_state_dict(flax_to_torch(variables["params"], variables["batch_stats"]))
    topt = P.make_optimizer(tmodel, tcfg)
    ttraj = P.Trajectory(**{k: torch.from_numpy(np.asarray(v)) for k, v in data.items()})
    tm = P.make_ppo_update(tmodel, tadapter, tcfg, topt)(
        ttraj, torch.from_numpy(nv), None, 0.01, perms=perms)

    for k in ("policy_loss", "value_loss", "score_loss", "entropy", "gradient_norm"):
        np.testing.assert_allclose(tm[k], float(jm[k]), rtol=1e-3, atol=1e-6, err_msg=k)
    want = flax_to_torch(jax.device_get(new_state.params),
                         jax.device_get(new_state.batch_stats))
    sd = tmodel.state_dict()
    for k, v in want.items():
        np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=1e-3, atol=2e-6, err_msg=k)


def test_ppo_update_rejects_empty_minibatch():
    tmodel, _ = build_model("se_resnet", {**TINY, "dtype": "float32"})
    cfg = P.KataGoPPOParams(batch_size=1024)
    data, nv = _trajectory(4, T=2, N=2)
    traj = P.Trajectory(**{k: torch.from_numpy(np.asarray(v)) for k, v in data.items()})
    update = P.make_ppo_update(tmodel, get_value_adapter("katago"), cfg,
                               P.make_optimizer(tmodel, cfg))
    with pytest.raises(ValueError, match="exceeds"):
        update(traj, torch.from_numpy(nv), None, 0.01)

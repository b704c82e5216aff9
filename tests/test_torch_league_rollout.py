"""The league rollout against the JAX package: masked GAE, and the compact
(parity-locked) and dynamic split-merge rollouts with JAX's draws
replayed. (The weighted PPO update on a league trajectory is held in
tests/test_torch_training.py, beside the self-play update whose
op-by-op JAX run it shares.)

JAX's threefry and torch's Philox never agree, so the JAX rollout's
`masked_policy_sample` (and, on the dynamic path, its color draw) is
wrapped to record every draw through an ordered io_callback; the port's
rollout replays them through its `sampler` / `recolor` hooks in the same
order (learner first, then opponent blocks in index order).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import io_callback

from keisei_tpu.env.vec_env import EnvCore as JaxEnvCore
from keisei_tpu.models.registry import build_model as jax_build_model
from keisei_tpu.training import gae as JG
from keisei_tpu.training import league_rollout as JLR
from keisei_tpu.training.value_adapter import MultiHeadValueAdapter as JaxAdapter
from keisei_tpu_torch.env.vec_env import EnvCore
from keisei_tpu_torch.models.convert import flax_to_torch
from keisei_tpu_torch.models.registry import build_model
from keisei_tpu_torch.training import gae as G
from keisei_tpu_torch.training.league_rollout import (compact_supported, make_league_rollout,
                                                      parity_colors)
from keisei_tpu_torch.training.value_adapter import get_value_adapter

torch.set_num_threads(2)

TINY = {"num_blocks": 1, "channels": 16, "global_pool_channels": 8, "se_reduction": 4}
ADAPTER = dict(lambda_value=1.5, lambda_score=0.1, score_blend_alpha=0.1)


# -- masked GAE (TestMaskedGAE's cases) ------------------------------------------


def _masked_gae_both(rewards, values, dones, valid, nv, gamma, lam, ov=None):
    j = JG.compute_gae_masked(jnp.asarray(rewards), jnp.asarray(values), jnp.asarray(dones),
                              jnp.asarray(valid), jnp.asarray(nv), gamma, lam,
                              None if ov is None else jnp.asarray(ov))
    t = G.compute_gae_masked(torch.from_numpy(rewards), torch.from_numpy(values),
                             torch.from_numpy(dones), torch.from_numpy(valid),
                             torch.from_numpy(nv), gamma, lam,
                             None if ov is None else torch.from_numpy(ov))
    return t.numpy(), np.asarray(j)


@pytest.mark.parametrize("case", ["dense_valid", "sparse", "override"])
def test_masked_gae_matches_jax(case):
    """f32 on both sides, the same recurrence: rtol 1e-6."""
    rng = np.random.default_rng({"dense_valid": 0, "sparse": 1, "override": 2}[case])
    T, N = 16, 5
    rewards = rng.normal(size=(T, N)).astype(np.float32)
    values = rng.normal(size=(T, N)).astype(np.float32)
    dones = rng.random((T, N)) < 0.15
    nv = rng.normal(size=N).astype(np.float32)
    valid = np.ones((T, N), bool) if case == "dense_valid" else rng.random((T, N)) < 0.5
    ov = None
    if case == "override":
        ov = np.where(dones & (rng.random((T, N)) < 0.6), rng.normal(size=(T, N)),
                      np.nan).astype(np.float32)
    got, want = _masked_gae_both(rewards, values, dones, valid, nv, 0.99, 0.95, ov)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert (got[~valid] == 0).all()
    if case == "dense_valid":  # all-valid equals the plain GAE
        plain = G.compute_gae(torch.from_numpy(rewards), torch.from_numpy(values),
                              torch.from_numpy(dones), torch.from_numpy(nv), 0.99, 0.95)
        np.testing.assert_allclose(got, plain.numpy(), rtol=1e-5, atol=1e-6)


def test_masked_gae_override_survives_done_cut():
    one = np.ones((1, 1), np.float32)
    got, want = _masked_gae_both(one, one * 0.5, np.ones((1, 1), bool), np.ones((1, 1), bool),
                                 np.asarray([9.9], np.float32), 0.5, 1.0, one * 2.0)
    assert got[0, 0] == pytest.approx(1.5) and want[0, 0] == pytest.approx(1.5)


# -- the rollouts -------------------------------------------------------------------


@functools.cache
def _init(params: tuple):
    """(flax model, jitted init): one compile serves every seed."""
    jmodel, _ = jax_build_model("se_resnet", dict(params))
    return jmodel, jax.jit(lambda key: jmodel.init(key, jnp.zeros((2, 50, 9, 9)), train=False))


def _variables(seed, params=TINY):
    jmodel, init = _init(tuple(params.items()))
    return jmodel, jax.device_get(init(jax.random.key(seed)))


def _run_jax(monkeypatch, N, T, K, max_ply, color_randomization, colors):
    """The reference rollout, its draws recorded in call order."""
    draws = []

    def record(x):
        draws.append(np.asarray(x))

    orig_sample, orig_bernoulli = JLR.masked_policy_sample, jax.random.bernoulli

    def sample(out, masks, rng, adapter):
        actions, logp, values = orig_sample(out, masks, rng, adapter)
        io_callback(record, None, actions, ordered=True)
        return actions, logp, values

    def bernoulli(key, p, shape):
        colors_ = orig_bernoulli(key, p, shape)
        io_callback(record, None, colors_, ordered=True)
        return colors_

    monkeypatch.setattr(JLR, "masked_policy_sample", sample)
    monkeypatch.setattr(jax.random, "bernoulli", bernoulli)
    jmodel, learner = _variables(0)
    opps = [jax.tree.map(lambda x: x.astype(jnp.bfloat16)
                         if jnp.issubdtype(x.dtype, jnp.floating) else x, _variables(i + 1)[1])
            for i in range(K)]
    stacked = JLR.stack_opponent_variables(opps)
    env = JaxEnvCore(N, max_ply, 50)
    roll = jax.jit(JLR.make_league_rollout(env, jmodel, JaxAdapter(**ADAPTER), T, K,
                                           color_randomization=color_randomization))
    carry, traj, nv, stats = roll(learner, stacked, *env.init(), jnp.asarray(colors),
                                  jax.random.key(7))
    jax.block_until_ready(traj)
    return learner, opps, draws, carry, traj, nv, stats


def _run_port(learner, opps, draws, N, T, K, max_ply, color_randomization, colors):
    model, _ = build_model("se_resnet", TINY)
    model.load_state_dict(flax_to_torch(learner["params"], learner["batch_stats"]))
    sds = [flax_to_torch(o["params"], o["batch_stats"]) for o in opps]
    stacked = {k: torch.stack([sd[k] for sd in sds]).to(torch.bfloat16) for k in sds[0]}
    env = EnvCore(N, max_ply, 50, device="cpu")
    roll = make_league_rollout(env, model, get_value_adapter("katago", **ADAPTER), T, K,
                               color_randomization=color_randomization)
    it = iter(draws)
    calls = []

    def sampler(ply, seat, block, masks):
        calls.append((ply, seat, block))
        a = next(it)
        assert a.shape == (masks.shape[0],), (ply, seat, block)
        return torch.from_numpy(a.astype(np.int64))

    def recolor(ply):
        return torch.from_numpy(next(it).astype(np.int32))

    out = roll(stacked, *env.init(), torch.from_numpy(np.asarray(colors)), None,
               sampler=sampler, recolor=recolor)
    assert next(it, None) is None, "the port made fewer draws than the reference"
    return out, calls


CASES = {
    # name: (N, T, K, max_ply, color_randomization, colors)
    "compact": (8, 8, 2, 5, True, "parity"),
    "dynamic_odd_t_odd_k": (6, 7, 3, 4, True, [0, 1] * 3),
    "dynamic_fixed_colors": (4, 8, 2, 5, False, [0] * 4),
}


@pytest.mark.parametrize("case", list(CASES))
def test_league_rollout_matches_jax(monkeypatch, case):
    """Engine-side fields exactly (obs, masks, actions, rewards, flags,
    categories, score targets, valid, the NaN pattern of the overrides,
    LeagueStats, the carried colors); model outputs at the self-play
    slice's bounds: values, overrides and next values atol 0.1, log-probs
    atol 0.3 (bf16 on both sides, opponents on bf16 weights). max_ply 4-5
    makes every game truncate inside the rollout, so deferral, the
    -V(terminal) bootstrap and the colors' re-assignment are all exercised."""
    N, T, K, max_ply, cr, colors = CASES[case]
    colors = np.asarray(parity_colors(N) if colors == "parity" else colors, np.int32)
    learner, opps, draws, jcarry, jtraj, jnv, jstats = _run_jax(
        monkeypatch, N, T, K, max_ply, cr, colors)
    ((_, tobs, tmask, tcolor), traj, tnv, tstats), calls = _run_port(
        learner, opps, draws, N, T, K, max_ply, cr, colors)

    compact = compact_supported(T, K, cr)
    assert compact == JLR.compact_supported(T, K, cr)
    assert traj.valid.shape == ((T // 2 + 1) if compact else (T + 1), N)
    per_ply = 1 + (K // 2 if compact else K)
    assert [c[0] for c in calls] == [t for t in range(T) for _ in range(per_ply)]
    for name in ("obs", "actions", "rewards", "dones", "terminated", "legal_masks",
                 "value_cats", "score_targets", "valid"):
        np.testing.assert_array_equal(getattr(traj, name).numpy(),
                                      np.asarray(getattr(jtraj, name)), err_msg=name)
    valid = traj.valid.numpy()
    assert valid.any() and traj.dones.numpy().any()
    jov, tov = np.asarray(jtraj.next_value_override), traj.next_value_override.numpy()
    np.testing.assert_array_equal(np.isnan(tov), np.isnan(jov))
    assert (~np.isnan(tov)).any(), "no truncation bootstrap was exercised"
    np.testing.assert_allclose(tov, jov, atol=0.1)
    np.testing.assert_allclose(traj.values.numpy()[valid], np.asarray(jtraj.values)[valid],
                               atol=0.1)
    np.testing.assert_allclose(traj.log_probs.numpy()[valid],
                               np.asarray(jtraj.log_probs)[valid], atol=0.3)
    np.testing.assert_allclose(tnv.numpy(), np.asarray(jnv), atol=0.1)
    np.testing.assert_array_equal(tobs.numpy(), np.asarray(jcarry[1]))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jcarry[2]))
    np.testing.assert_array_equal(tcolor.numpy(), np.asarray(jcarry[3]))
    jst = jax.tree.map(np.asarray, jstats)
    for name in ("episodes", "wins_black", "wins_white", "draws", "terminated",
                 "truncated", "total_ply"):
        assert getattr(tstats.base, name) == int(getattr(jst.base, name)), name
    for name in ("opp_wins", "opp_losses", "opp_draws"):
        assert getattr(tstats, name) == getattr(jst, name).tolist(), name
    assert tstats.parity_mismatch == int(jst.parity_mismatch) == 0
    if compact:  # every env finalizes one learner move per pair of plies
        assert (valid.sum(axis=0) == T // 2).all()


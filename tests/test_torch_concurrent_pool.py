"""The concurrent match pool against the JAX package's: P pairings in one
batched environment, one stacked forward over the 2P weight sets a ply.

JAX's threefry and torch's Philox never agree, so the JAX pool's chunk is
wrapped to record the actions it played (every env, pad slots included),
and the port's pool replays them through its `sampler` hook. With the same
actions the games are the same games: results, RoundStats and every
engine-side field of the per-slot rollouts must be equal. The stacked
forward itself is held to JAX's per-slot `model.apply` on the same bf16
weights at the bf16 bound of the league slice (policy atol 0.15).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keisei_tpu.league import concurrent as JCP
from keisei_tpu.models.registry import build_model as jax_build_model
from keisei_tpu_torch.league.concurrent import ConcurrentMatchPool, stack_pairings
from keisei_tpu_torch.models.convert import flax_to_torch
from keisei_tpu_torch.models.registry import build_model
from keisei_tpu_torch.training.league_rollout import opponent_module

torch.set_num_threads(2)

TINY = {"num_blocks": 2, "channels": 16, "global_pool_channels": 8, "se_reduction": 4}
P, E, MAX_PLY, CHUNK = 3, 2, 24, 16
ROUNDS = {"three_pairings": [(0, 1), (2, 3), (1, 2)], "two_padded": [(3, 0), (1, 3)]}
SEEDS = {"three_pairings": 11, "two_padded": 12}


@functools.cache
def _jax_model():
    jmodel, _ = jax_build_model("se_resnet", TINY)
    return jmodel, jax.jit(lambda key: jmodel.init(key, jnp.zeros((2, 50, 9, 9)), train=False))


def _weights(i: int):
    """(JAX bf16 variables, port bf16 state dict) of weight set i, with
    BatchNorm statistics drawn away from their init so that they matter."""
    jmodel, init = _jax_model()
    v = jax.device_get(init(jax.random.key(i)))
    rng = np.random.default_rng(100 + i)

    def perturb(path, x):
        name = jax.tree_util.keystr(path)
        if "var" in name:
            return (rng.uniform(0.5, 1.5, x.shape)).astype(np.float32)
        return (rng.normal(size=x.shape) * 0.1).astype(np.float32)
    stats = jax.tree_util.tree_map_with_path(perturb, v["batch_stats"])
    v = {"params": v["params"], "batch_stats": stats}
    jv = jax.tree.map(lambda x: jnp.asarray(x).astype(jnp.bfloat16), v)
    tv = {k: t.to(torch.bfloat16) for k, t in flax_to_torch(v["params"], stats).items()}
    return jv, tv


@pytest.fixture(scope="module")
def jax_rounds():
    """Each round of ROUNDS through the JAX pool (full collection), with the
    actions of every env recorded chunk by chunk."""
    jmodel, _ = _jax_model()
    weights = [_weights(i) for i in range(4)]
    recorded: list = []
    orig = JCP.ConcurrentMatchPool._build_chunk

    def build(self, mode="none"):
        fn = orig(self, mode)

        def chunk(*args):
            carry, ys = fn(*args)
            recorded.append(np.asarray(ys[1]))
            return carry, ys

        return chunk

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JCP.ConcurrentMatchPool, "_build_chunk", build)
        pool = JCP.ConcurrentMatchPool(jmodel, parallel_matches=P, envs_per_match=E,
                                       max_ply=MAX_PLY, chunk_steps=CHUNK)
        out = {}
        for name, pairs in ROUNDS.items():
            recorded.clear()
            results, stats, rollouts = pool.run_round(
                [(weights[a][0], weights[b][0]) for a, b in pairs], seed=SEEDS[name],
                collect=True)
            out[name] = (results, stats, jax.device_get(rollouts),
                         np.concatenate(recorded))
    return weights, out


def _port_pool():
    twin = opponent_module(build_model("se_resnet", TINY)[0])
    return ConcurrentMatchPool(twin, parallel_matches=P, envs_per_match=E, max_ply=MAX_PLY,
                               chunk_steps=CHUNK, device="cpu")


def _replay(actions: np.ndarray):
    calls = []

    def sampler(step, masks):
        calls.append(step)
        assert masks.shape[0] == P * E
        return torch.from_numpy(actions[step].astype(np.int64))

    return sampler, calls


FIELDS = ("actions", "rewards", "dones", "mover_color", "captured", "term_reason", "a_color")


@pytest.mark.parametrize("collect", [True, "light", False], ids=["full", "light", "none"])
@pytest.mark.parametrize("name", list(ROUNDS))
def test_pool_matches_jax_under_replayed_draws(jax_rounds, name, collect):
    """Results, RoundStats and the per-slot rollouts equal JAX's, at 3
    pairings and at 2 (padded with the last), in every collect mode. JAX
    collects fully once: its draws, results and trajectory do not depend on
    the collect mode, so the light and plain runs are held to the same
    record."""
    weights, out = jax_rounds
    jresults, jstats, jrollouts, actions = out[name]
    pairs = ROUNDS[name]
    sampler, calls = _replay(actions)
    got = _port_pool().run_round([(weights[a][1], weights[b][1]) for a, b in pairs],
                                 seed=SEEDS[name], collect=collect, sampler=sampler)
    results, stats = got[0], got[1]
    assert calls == list(range(len(actions))), "the port played another number of plies"
    assert [vars(r) for r in results] == [vars(r) for r in jresults]
    assert vars(stats) == {k: int(v) for k, v in vars(jstats).items()}
    assert stats.pairings == len(pairs) and stats.games == len(pairs) * E
    if not collect:
        assert len(got) == 2
        return
    rollouts = got[2]
    assert len(rollouts) == len(pairs)
    for tr, jr in zip(rollouts, jrollouts):
        for f in FIELDS:
            np.testing.assert_array_equal(getattr(tr, f).numpy(), np.asarray(getattr(jr, f)),
                                          err_msg=f)
        if collect == "light":
            assert tr.obs is None and tr.legal_masks is None
        else:
            np.testing.assert_array_equal(tr.obs.numpy(),
                                          np.asarray(jr.obs).reshape(tr.obs.shape))
            np.testing.assert_array_equal(tr.legal_masks.numpy(), np.asarray(jr.legal_masks))


def test_stacked_forward_matches_jax_per_slot(jax_rounds):
    """The pool's one forward over 2P weight sets against JAX's model.apply
    of each set alone, on boards from the JAX round: legal logits within
    0.15 (bf16 compute on both sides), illegal ones at -1e9 on both."""
    weights, out = jax_rounds
    jmodel, _ = _jax_model()
    _, _, jrollouts, _ = out["three_pairings"]
    pairs = ROUNDS["three_pairings"]
    obs = np.stack([np.asarray(jr.obs[5]).reshape(E, 50, 81) for jr in jrollouts])
    masks = np.stack([np.asarray(jr.legal_masks[5]) for jr in jrollouts])
    pool = _port_pool()
    stacked = stack_pairings([(weights[a][1], weights[b][1]) for a, b in pairs])
    got = pool.stacked_forward(stacked, torch.from_numpy(np.concatenate([obs, obs])),
                               torch.from_numpy(np.concatenate([masks, masks]))).numpy()
    order = [a for a, _ in pairs] + [b for _, b in pairs]
    for g, w in enumerate(order):
        p = g % P
        ref = jmodel.apply(weights[w][0], jnp.asarray(obs[p]).reshape(E, 50, 9, 9),
                           train=False).policy_logits.reshape(E, -1).astype(jnp.float32)
        ref = np.where(masks[p], np.asarray(ref), -1e9)
        np.testing.assert_array_equal(got[g] == -1e9, ref == -1e9)
        legal = masks[p]
        np.testing.assert_allclose(got[g][legal], ref[legal], atol=0.15, err_msg=f"slot {g}")


def test_slot_isolation(jax_rounds):
    """Zeroing one weight set changes that set's logits and no other's."""
    weights, _ = jax_rounds
    pool = _port_pool()
    stacked = stack_pairings([(weights[0][1], weights[1][1]), (weights[2][1], weights[3][1]),
                              (weights[1][1], weights[2][1])])
    rng = np.random.default_rng(0)
    obs = torch.from_numpy((rng.random((2 * P, E, 50, 81)) < 0.2).astype(np.float32))
    masks = torch.from_numpy(rng.random((2 * P, E, 11259)) < 0.05)
    base = pool.stacked_forward(stacked, obs, masks)
    zeroed = {k: v.clone() for k, v in stacked.items()}
    for v in zeroed.values():
        v[4] = 0
    after = pool.stacked_forward(zeroed, obs, masks)
    for g in range(2 * P):
        if g == 4:
            assert not torch.equal(after[g], base[g])
        else:
            torch.testing.assert_close(after[g], base[g], rtol=0, atol=0)


def test_pool_own_draws_and_capacity(jax_rounds):
    """Without a sampler the pool draws from its seeded generator: a round
    is reproducible from its seed and every game of every pairing
    finishes; more pairings than slots are refused, none give nothing."""
    weights, _ = jax_rounds
    pool = _port_pool()
    pairs = [(weights[0][1], weights[1][1]), (weights[2][1], weights[3][1])]
    r1, s1, roll1 = pool.run_round(pairs, seed=3, collect="light")
    r2, s2, roll2 = pool.run_round(pairs, seed=3, collect="light")
    assert [vars(r) for r in r1] == [vars(r) for r in r2] and s1 == s2
    assert torch.equal(roll1[0].actions, roll2[0].actions)
    assert s1.games == 2 * E and all(r.games == E for r in r1)
    assert pool.run_round([], seed=0) == ([], type(s1)(0, 0, 0, 0))
    with pytest.raises(ValueError, match="pool capacity"):
        pool.run_round(pairs * 2, seed=0)

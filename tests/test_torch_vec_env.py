"""The port's VecEnv host shim on tests/test_vec_env.py's cases, and step
for step against the JAX package's VecEnv on the same actions (every
array of the StepResult contract equal, the counters, the SFEN and the
spectator feed). The flat action tables are held in
tests/test_torch_copies.py."""

import numpy as np
import pytest

from keisei_tpu.env.vec_env import VecEnv as JaxVecEnv
from keisei_tpu_torch.engine import types as TY
from keisei_tpu_torch.env.vec_env import FLAT_TO_SPATIAL, SPATIAL_TO_FLAT, VecEnv


@pytest.fixture(scope="module")
def env():
    return VecEnv(num_envs=8, max_ply=64, observation_mode="katago", action_mode="spatial",
                  device="cpu")


def _random_legal(rng, masks):
    return np.array([rng.choice(np.nonzero(m)[0]) for m in masks], dtype=np.int64)


def test_flat_encoding_matches_reference_formula():
    valid = SPATIAL_TO_FLAT < TY.FLAT_ACTION_SPACE
    idx = np.nonzero(valid)[0]
    assert np.array_equal(FLAT_TO_SPATIAL[SPATIAL_TO_FLAT[idx]], idx)
    sq, to = 76, 58  # from (8,4), slot N dist 2 -> (6,4)
    assert SPATIAL_TO_FLAT[sq * 139 + 1] == sq * 160 + (to if to < sq else to - 1) * 2
    assert SPATIAL_TO_FLAT[40 * 139 + 132] == 12960 + 40 * 7  # drop pawn at 40


def test_reset_contract(env):
    r = env.reset()
    assert r.observations.shape == (8, 50, 9, 9) and r.observations.dtype == np.float32
    assert r.legal_masks.shape == (8, TY.ACTION_SPACE)
    assert r.legal_masks.sum(axis=1).tolist() == [30] * 8


def test_step_contract_and_stats(env):
    masks = env.reset().legal_masks
    env.reset_stats()
    rng = np.random.default_rng(0)
    done_seen = 0
    for _ in range(70):
        res = env.step(_random_legal(rng, masks))
        assert res.observations.shape == (8, 50, 9, 9)
        assert res.current_players.dtype == np.uint8
        assert res.step_metadata.material_balance.shape == (8,)
        assert res.step_metadata.ply_count.dtype == np.uint16
        masks = res.legal_masks
        done_seen += int((res.terminated | res.truncated).sum())
    assert done_seen >= 8  # 70 steps at max_ply 64: every env truncated once
    assert env.episodes_completed == done_seen
    assert env.mean_episode_length > 0 and 0.0 <= env.truncation_rate <= 1.0


def test_illegal_and_out_of_range_actions_are_rejected(env):
    masks = env.reset().legal_masks
    illegal = int(np.nonzero(~masks[0])[0][0])
    actions = np.array([illegal] + [np.nonzero(masks[i])[0][0] for i in range(1, 8)])
    with pytest.raises(ValueError, match="illegal"):
        env.step(actions)
    with pytest.raises(ValueError, match="out of range"):
        env.step(np.full(8, TY.ACTION_SPACE, dtype=np.int64))
    with pytest.raises(ValueError, match="expected 8 actions"):
        env.step(np.zeros(3, dtype=np.int64))


def test_get_sfen(env):
    env.reset()
    assert env.get_sfen(0).startswith("lnsgkgsnl/1r5b1/ppppppppp")


@pytest.mark.parametrize("mode", ["flat", "spatial"])
def test_steps_match_the_jax_vec_env(mode):
    """30 random legal steps at max_ply 12 (every env truncates twice) in
    the flat action space with the 46-plane observation, and in the
    spatial one with the 50 planes."""
    obs_mode, act_mode = ("default", "default") if mode == "flat" else ("katago", "spatial")
    ours = VecEnv(4, 12, obs_mode, act_mode, device="cpu")
    ref = JaxVecEnv(4, 12, obs_mode, act_mode)
    a, b = ours.reset(), ref.reset()
    np.testing.assert_array_equal(a.observations, b.observations)
    np.testing.assert_array_equal(a.legal_masks, b.legal_masks)
    rng = np.random.default_rng(5)
    masks = a.legal_masks
    for _ in range(30):
        actions = _random_legal(rng, masks)
        a, b = ours.step(actions), ref.step(actions)
        for name in ("observations", "legal_masks", "rewards", "terminated", "truncated",
                     "terminal_observations", "current_players"):
            x, y = getattr(a, name), getattr(b, name)
            assert x.dtype == y.dtype, name
            np.testing.assert_array_equal(x, y, err_msg=name)
        for name in ("captured_piece", "termination_reason", "ply_count", "material_balance"):
            np.testing.assert_array_equal(getattr(a.step_metadata, name),
                                          getattr(b.step_metadata, name), err_msg=name)
        masks = a.legal_masks
    for name in ("episodes_completed", "episodes_drawn", "episodes_truncated",
                 "total_episode_ply"):
        assert getattr(ours, name) == getattr(ref, name), name
    assert [ours.get_sfen(i) for i in range(4)] == [ref.get_sfen(i) for i in range(4)]
    assert ours.get_spectator_data() == ref.get_spectator_data()

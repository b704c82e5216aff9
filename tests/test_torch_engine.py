"""The port's batched rules engine against the JAX engine, exactly.

Random legal playouts go through JAX `EnvCore.step_fn()` and the port's
`EnvCore.step` with the same actions (drawn by numpy among the legal
ones); every output and the hash history must be equal bit for bit.
Perft counts and scripted termination fixtures pin the rules directly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keisei_tpu.engine import core as JC
from keisei_tpu.engine import types as TY
from keisei_tpu.engine.sfen import parse_sfen
from keisei_tpu.env.vec_env import EnvCore as JaxEnvCore
from keisei_tpu.sl.encode import usi_to_action
from keisei_tpu_torch.engine import core as C
from keisei_tpu_torch.env.vec_env import EnvCore

torch.set_num_threads(2)

PERFT = {1: 30, 2: 900, 3: 25_470}  # tests/test_perft.py


@pytest.fixture(scope="module")
def tb():
    return C.EngineTables("cpu")


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("num_channels,max_ply,seed", [(50, 60, 0), (46, 200, 1)])
def test_random_playout_matches_jax(num_channels, max_ply, seed):
    """~200 plies per env; max_ply 60 forces truncations and auto-resets."""
    n, plies = 8, 200
    jenv = JaxEnvCore(n, max_ply, num_channels)
    jstep = jax.jit(jenv.step_fn())
    js, jobs, jmask = jenv.init()
    env = EnvCore(n, max_ply, num_channels)
    ts, tobs, tmask = env.init()
    np.testing.assert_array_equal(_np(tobs), np.asarray(jobs))
    np.testing.assert_array_equal(_np(tmask), np.asarray(jmask))

    rng = np.random.default_rng(seed)
    reasons = set()
    for t in range(plies):
        m = np.asarray(jmask)
        actions = np.array([rng.choice(np.flatnonzero(m[i])) for i in range(n)], np.int32)
        js, jo = jstep(js, jnp.asarray(actions))
        ts, to = env.step(ts, torch.as_tensor(actions))
        for name in ("obs", "legal_mask", "reward", "terminated", "truncated",
                     "terminal_obs", "current_player", "captured", "term_reason",
                     "ply_count", "material"):
            np.testing.assert_array_equal(
                _np(getattr(to, name)), np.asarray(getattr(jo, name)),
                err_msg=f"{name} differs at ply {t}")
        np.testing.assert_array_equal(C.hash_lanes(ts.hash_), np.asarray(js.hash_))
        np.testing.assert_array_equal(C.hash_lanes(ts.hash_hist), np.asarray(js.hash_hist))
        for name in ("board", "hands", "stm", "ply", "check_hist", "in_check",
                     "reason", "winner"):
            np.testing.assert_array_equal(_np(getattr(ts, name)), np.asarray(getattr(js, name)),
                                          err_msg=f"state.{name} differs at ply {t}")
        reasons.update(np.asarray(jo.term_reason).tolist())
        jmask = jo.legal_mask
    if max_ply == 60:
        assert TY.MAX_MOVES in reasons  # the auto-reset path was exercised


def _perft(tb, depth):
    st = C.init_state(1, 4, tb)
    boards, hands, stms = st.board, st.hands, st.stm
    for _ in range(depth - 1):
        pb = C.perspective_board(boards, stms)
        ar = torch.arange(boards.shape[0])
        m, _, _ = C.legal_mask_pspace(pb, hands[ar, stms.long()], tb)
        parents, actions = torch.nonzero(m.reshape(boards.shape[0], -1), as_tuple=True)
        child = C.init_state(len(parents), 4, tb)
        child.board, child.hands, child.stm = boards[parents], hands[parents], stms[parents]
        s1 = C.apply_action(child, actions, tb)
        boards, hands, stms = s1.board, s1.hands, s1.stm
    pb = C.perspective_board(boards, stms)
    ar = torch.arange(boards.shape[0])
    m, _, _ = C.legal_mask_pspace(pb, hands[ar, stms.long()], tb)
    return int(m.sum())


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_perft(tb, depth):
    assert _perft(tb, depth) == PERFT[depth]


def _play(env, state, moves):
    out = None
    for usi in moves:
        stm = int(state.stm[0])
        a = usi_to_action(usi, stm)
        pb = C.perspective_board(state.board, state.stm)
        m, _, _ = C.legal_mask_pspace(pb, state.hands[:, stm], env.tables)
        assert bool(m.reshape(-1)[a]), f"illegal {usi}"
        state, out = env.step(state, torch.tensor([a]))
    return state, out


def test_sennichite_fourfold_repetition_is_draw():
    """tests/test_engine_terminations.py::TestSennichite through the port."""
    env = EnvCore(1, 64, 46)
    state, _, _ = env.init()
    cycle = ["5i5h", "5a5b", "5h5i", "5b5a"]
    state, out = _play(env, state, cycle * 2 + cycle[:3])
    assert int(out.term_reason[0]) == TY.NOT_TERMINATED
    state, out = _play(env, state, [cycle[3]])
    assert int(out.term_reason[0]) == TY.REPETITION
    assert bool(out.terminated[0]) and float(out.reward[0]) == 0.0


def test_perpetual_check_victim_wins():
    env = EnvCore(1, 64, 46)
    board, hands, stm = parse_sfen("4k4/9/9/9/6R2/9/9/9/4K4 b - 1")
    state = C.state_from_position(board, hands, stm, 64, env.tables)
    cycle = ["5a4a", "5e4e", "4a5a", "4e5e"]
    state, out = _play(env, state, ["3e5e"] + cycle * 2 + cycle[:3])
    state, out = _play(env, state, [cycle[3]])
    assert int(out.term_reason[0]) == TY.PERPETUAL_CHECK
    assert float(out.reward[0]) == -1.0


@pytest.mark.parametrize("sfen,drop_sq,allowed", [
    ("8k/7G1/6S2/9/9/9/9/9/4K4 b P 1", 1 * 9 + 8, False),  # mating pawn drop
    ("8k/7G1/9/9/9/9/9/9/4K4 b P 1", 1 * 9 + 8, True),     # king escapes
    ("8k/7G1/6S2/9/9/9/9/9/4K4 b P 1", 4 * 9 + 4, True),   # harmless drop
])
def test_uchi_fu_zume_matches_jax(tb, sfen, drop_sq, allowed):
    """tests/test_engine_terminations.py::TestUchiFuZume, whole mask vs JAX."""
    board, hands, stm = parse_sfen(sfen)
    pb = C.perspective_board(torch.as_tensor(board)[None], torch.tensor([stm], dtype=torch.int8))
    m, _, _ = C.legal_mask_pspace(pb, torch.as_tensor(hands)[stm][None], tb)
    m = m.reshape(-1).numpy()
    assert m[drop_sq * 139 + 132 + TY.PAWN] == allowed
    jpb = JC.perspective_board(jnp.asarray(board), jnp.int8(stm))
    jm = np.asarray(JC.legal_mask_pspace(jpb, jnp.asarray(hands)[stm])[0]).reshape(-1)
    np.testing.assert_array_equal(m, jm)


def test_impasse_and_material_match_jax(tb):
    for sfen in ("K8/RB1PPPP2/3PPP3/9/9/9/3ppp3/rb1pppp2/k8 b 7P7p 1",
                 "K+R+B6/PPPPPPPPP/PPPPP4/9/9/9/ppppppppp/ppppppppp/k7r b - 1",
                 "4k4/9/9/9/+R8/9/9/9/4K4 b G 1"):
        board, hands, _ = parse_sfen(sfen)
        active, winner = C.impasse_check(torch.as_tensor(board)[None],
                                         torch.as_tensor(hands)[None], tb)
        ja, jw = JC.impasse_check(jnp.asarray(board), jnp.asarray(hands))
        assert bool(active[0]) == bool(ja) and int(winner[0]) == int(jw)
        for p in (0, 1):
            bal = C.material_balance(torch.as_tensor(board)[None], torch.as_tensor(hands)[None],
                                     torch.tensor([p]), tb)
            assert int(bal[0]) == int(JC.material_balance(
                jnp.asarray(board), jnp.asarray(hands), jnp.int32(p)))

"""The port's SpectatorEnv (keisei_tpu_torch/env/spectator.py) on the CPU
against the JAX package's (keisei_tpu/env/spectator.py), move for move:
seeded random games in both action modes, `from_sfen` with and without a
move number, a game seeded past max_ply's budget, an already decided
SFEN, the no-auto-reset mate, and the refusals of illegal actions and of
moves after the end.

At every ply the state dicts, the SFEN, `legal_actions`,
`legal_moves_with_usi`, the step dicts (reward and terminated included)
are equal and the observations equal bit for bit: tolerance exact. Every
JAX env here has max_ply 40, so its jitted programs compile once for the
module (they are cached per max_ply)."""

import numpy as np
import pytest
import torch

from keisei_tpu.env.spectator import SpectatorEnv as JaxSpectatorEnv
from keisei_tpu_torch.engine.sfen import STARTPOS_SFEN
from keisei_tpu_torch.env.spectator import SpectatorEnv
from keisei_tpu_torch.env.vec_env import FLAT_TO_SPATIAL

torch.set_num_threads(2)

MAX_PLY = 40
# White to move, mated: black gold on 5b, guarded by the pawn on 5c
MATED_SFEN = "4k4/4G4/4P4/9/9/9/9/9/4K4 w - 1"
# Black to move with a gold in hand: G*5b mates
MATE_IN_ONE_SFEN = "4k4/9/4P4/9/9/9/9/9/4K4 b G 1"


def _pair(sfen=None, mode="spatial"):
    if sfen is None:
        return (JaxSpectatorEnv(MAX_PLY, mode), SpectatorEnv(MAX_PLY, mode, device="cpu"))
    return (JaxSpectatorEnv.from_sfen(sfen, MAX_PLY, mode),
            SpectatorEnv.from_sfen(sfen, MAX_PLY, mode, device="cpu"))


def _assert_same(j, p):
    assert p.to_dict() == j.to_dict()
    assert p.to_sfen() == j.to_sfen()
    assert p.is_over() == j.is_over()
    assert p.ply == j.ply and p.current_player() == j.current_player()
    assert p.legal_actions() == j.legal_actions()
    assert p.legal_moves_with_usi() == j.legal_moves_with_usi()
    oj, op = j.get_observation(), p.get_observation()
    assert op.shape == oj.shape == (46, 9, 9) and op.dtype == oj.dtype
    assert op.tobytes() == oj.tobytes()


def _play(j, p, rng, max_moves=MAX_PLY):
    """Random legal moves on both envs until the game ends; returns the
    last step dict."""
    _assert_same(j, p)
    d = None
    for _ in range(max_moves):
        if j.is_over():
            break
        a = int(rng.choice(j.legal_actions()))
        d = j.step(a)
        assert p.step(a) == d
        _assert_same(j, p)
    return d


@pytest.mark.parametrize("mode", ["spatial", "default"])
def test_random_games_equal_the_jax_env(mode):
    """Two seeded games each to max_ply (or an earlier end), then a reset
    and part of a third."""
    j, p = _pair(mode=mode)
    assert p.action_space_size == j.action_space_size
    rng = np.random.default_rng(11 if mode == "spatial" else 12)
    for _ in range(2):
        d = _play(j, p, rng)
        assert j.is_over() and d["terminated"]
        assert p.reset() == j.reset()
    _play(j, p, rng, max_moves=6)


@pytest.mark.parametrize("sfen", [
    "lnsgkgsnl/1r5b1/ppppppppp/9/9/9/PPPPPPPPP/1B5R1/LNSGKGSNL w - 1",
    "lnsgkgsnl/1r5b1/ppppppppp/9/9/9/PPPPPPPPP/1B5R1/LNSGKGSNL w -",
    "ln1gkgsnl/1r1s3b1/pppppp1pp/6p2/9/2P6/PP1PPPPPP/1B5R1/LNSGKGSNL b Pp 31",
], ids=["move_1", "no_move_number", "move_31_with_hands"])
def test_from_sfen_equals_the_jax_env(sfen):
    """The move number seeds the ply (its observation plane and the
    budget left to max_ply); the game then runs to its end."""
    j, p = _pair(sfen, mode="default")
    want_ply = int(sfen.split()[3]) - 1 if len(sfen.split()) > 3 else 0
    assert p.ply == j.ply == want_ply
    _play(j, p, np.random.default_rng(3))
    assert p.is_over()


@pytest.mark.parametrize("move_number", [41, 45])
def test_a_game_seeded_past_max_ply_is_over(move_number):
    """A position whose move number leaves no budget is over at once
    (max_moves), with no legal actions, and refuses a move."""
    sfen = f"{STARTPOS_SFEN.rsplit(' ', 1)[0]} {move_number}"
    j, p = _pair(sfen)
    _assert_same(j, p)
    assert p.is_over() and p.to_dict()["result"] == "max_moves"
    with pytest.raises(ValueError, match="over"):
        p.step(0)


def test_a_decided_sfen_is_over_with_its_winner():
    j, p = _pair(MATED_SFEN)
    _assert_same(j, p)
    assert p.is_over() and p.to_dict()["result"] == "checkmate"
    assert p.winner == int(j._state.winner) == 0
    assert p.legal_actions() == [] and p.legal_moves_with_usi() == []


def test_mate_does_not_auto_reset():
    """G*5b mates: the step's reward is +1 for the mover, the game stays
    over until reset(), and a move after the end raises."""
    j, p = _pair(MATE_IN_ONE_SFEN)
    a = next(a for a, usi in j.legal_moves_with_usi() if usi == "G*5b")
    d = j.step(a)
    assert p.step(a) == d
    _assert_same(j, p)
    assert d["terminated"] and d["reward"] == 1.0 and d["result"] == "checkmate"
    assert p.winner == 0
    for env in (j, p):
        with pytest.raises(ValueError, match="over"):
            env.step(a)
    assert p.reset() == j.reset()
    _assert_same(j, p)
    assert not p.is_over() and p.ply == 0


def test_illegal_actions_raise_as_in_the_jax_env():
    for mode in ("spatial", "default"):
        j, p = _pair(mode=mode)
        no_geometry = int(np.flatnonzero(FLAT_TO_SPATIAL < 0)[0])
        bad = [0, -1] if mode == "spatial" else [no_geometry]
        for a in bad:
            with pytest.raises(ValueError) as theirs:
                j.step(a)
            with pytest.raises(ValueError) as ours:
                p.step(a)
            assert str(ours.value) == str(theirs.value)
        _assert_same(j, p)
    with pytest.raises(ValueError, match="action_mode"):
        SpectatorEnv(action_mode="bogus", device="cpu")
    with pytest.raises(ValueError):
        SpectatorEnv.from_sfen("not-a-sfen", device="cpu")

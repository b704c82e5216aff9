"""The port's supervised pipeline against the JAX package's: USI -> action
geometry over every action id, the batched encoder bit for bit (SFEN and
CSA games, a custom start position, illegal tails, games of unequal
length in one chunk, engine-played games with captures and drops),
`prepare_sl_data`'s shards byte for byte, the SL trainer step by step
(losses, learning rates, parameters and BatchNorm statistics, with the
JAX step run op by op under `jax.disable_jit()`) and `evaluate`'s metrics
(a tie at the 5th logit included), and the port's corpus generator
against the JAX package's script (the same files from one seed), read
back through both packages' CSA parsers.

Encoder shapes are chosen so that the JAX replay program is compiled for
few (G, L) pairs; the trainer compares at the tolerances of
tests/test_torch_training.py."""

import json
import runpy
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from keisei_tpu.env import spectator_data as jax_spectator
from keisei_tpu.sl import dataset as JD
from keisei_tpu.sl import encode as JE
from keisei_tpu.sl import parsers as JPAR
from keisei_tpu.sl.prepare import prepare_sl_data as jax_prepare
from keisei_tpu.sl.trainer import SLConfig as JaxSLConfig
from keisei_tpu.sl.trainer import SLTrainer as JaxSLTrainer
from keisei_tpu_torch.engine import types as TY
from keisei_tpu_torch.env import spectator_data
from keisei_tpu_torch.models.convert import flax_to_torch
from keisei_tpu_torch.scripts.generate_sl_corpus import generate_corpus
from keisei_tpu_torch.sl import dataset as D
from keisei_tpu_torch.sl import encode as E
from keisei_tpu_torch.sl import parsers as PAR
from keisei_tpu_torch.sl.prepare import prepare_sl_data
from keisei_tpu_torch.sl.trainer import SLConfig, SLTrainer, cosine_decay_lr
from keisei_tpu_torch.utils.timing import union_us

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
TINY = {"num_blocks": 2, "channels": 16, "global_pool_channels": 8, "se_reduction": 4}

SFEN_GAMES = """\
result:win_black
startpos
7g7f
3c3d
8h2b+
3a2b
B*4e

result:draw
startpos
2g2f
8c8d

result:win_black
startpos
7g7f
7g7f
3c3d

result:win_white
startpos
5i5h
5a5b
5h5b
4a4b

result:win_black
4k4/9/9/9/R8/9/9/9/4K4 b - 1
9e9a+
5a5b
9a9b

result:win_white
startpos
7g7f
3c3d
2g2f
2b8h+
2f2e
8h7i+

result:draw
startpos
""" + "P*5e\n" * 40

CSA_GAME = """\
V2.2
N+PlayerBlack
N-PlayerWhite
PI
+
+7776FU
-3334FU
+8822UM
-3122GI
+0045KA
%TORYO
"""


# -- USI geometry ----------------------------------------------------------------------


@pytest.mark.parametrize("stm", [0, 1])
def test_usi_to_action_equals_jax_over_every_action(stm):
    """Every on-board action id decodes (through the port's spectator
    data) to a USI string that both packages map back to that id."""
    on_board = 0
    for action in range(TY.ACTION_SPACE):
        is_drop, frm, to, _, _ = spectator_data.decode_action_np(action, stm)
        if not is_drop and (to < 0 or to > 80 or frm == to):
            continue
        on_board += 1
        usi = spectator_data.move_usi(action, stm)
        assert usi == jax_spectator.move_usi(action, stm)
        assert E.usi_to_action(usi, stm) == action == JE.usi_to_action(usi, stm), usi
    assert on_board == 5015
    for file in range(1, 10):
        for rank in "abcdefghi":
            assert E.usi_square(f"{file}{rank}") == JE.usi_square(f"{file}{rank}")


# -- sources -------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sources(tmp_path_factory) -> Path:
    """One directory of game files: the SFEN games above (a custom start,
    illegal tails: a king capture, a promoted piece promoting, drops from
    an empty hand), the CSA game, and six games
    the port's engine played (CSA, captures and drops among their moves)."""
    src = tmp_path_factory.mktemp("sl_sources")
    generate_corpus(str(src), games=6, envs=6, max_ply=40, games_per_file=3, seed=3,
                    device="cpu")
    (src / "games.sfen").write_text(SFEN_GAMES)
    (src / "game.csa").write_text(CSA_GAME)
    return src


def _records(parsers_mod, src: Path) -> list:
    recs = list(parsers_mod.SFENParser().parse(src / "games.sfen"))
    for p in sorted(src.glob("*.csa")):
        recs += list(parsers_mod.CSAParser().parse(p))
    return recs


def _same_bits(a: np.ndarray, b: np.ndarray) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("batch_games", [16, 3])
def test_encoder_equals_jax_bit_for_bit(sources, batch_games):
    """All records in one chunk (games of 2 to 40 plies together) and in
    chunks of 3: the obs, policy, value and score arrays and the stats."""
    theirs = JE.GameEncoder(batch_games=batch_games).encode_games(_records(JPAR, sources))
    ours = E.GameEncoder(batch_games=batch_games, device="cpu").encode_games(
        _records(PAR, sources))
    for name, a, b in zip(("obs", "policy", "value", "score"), ours[:4], theirs[:4]):
        assert _same_bits(a, b), name
    assert ours[4] == theirs[4]
    # the illegal tails were dropped (a king capture, a promoted piece's
    # promotion and 40 drops from an empty hand among them: the replay
    # applies them and must not fault)
    corpus = json.loads((sources / "corpus_meta.json").read_text())
    assert ours[4] == {"positions": 18 + 5 + corpus["plies"], "dropped_moves": 45,
                       "dropped_games": 1}


def test_prepare_writes_the_jax_packages_shards(sources, tmp_path):
    kw = dict(min_ply=2, shard_size=100, batch_games=16)
    theirs = jax_prepare([str(sources)], str(tmp_path / "jax"), **kw)
    ours = prepare_sl_data([str(sources)], str(tmp_path / "port"), device="cpu", **kw)
    assert ours == theirs
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir())
    assert len([n for n in names if n.endswith(".bin")]) == -(-ours["positions"] // 100) > 1
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    meta = json.loads((tmp_path / "port" / "shard_meta.json").read_text())
    assert meta["total_positions"] == len(D.SLDataset(str(tmp_path / "port")))


# -- the trainer ----------------------------------------------------------------------


def _dataset(root: Path, n: int, seed: int) -> Path:
    rng = np.random.default_rng(seed)
    root.mkdir()
    obs = (rng.random((n, 4050)) < 0.15).astype(np.float32)
    pol = rng.integers(0, 11259, n)
    val = rng.integers(0, 3, n)
    sc = (rng.normal(size=n) * 0.3).astype(np.float32)
    D.write_shard(root / "shard_00000.bin", obs, pol, val, sc)
    D.write_meta(root, [n])
    return root


def _jax_trainer(cfg_kw, ds_dir, train_indices=None):
    jt = JaxSLTrainer(JaxSLConfig(**cfg_kw), "se_resnet", {**TINY, "dtype": jnp.float32},
                      JD.SLDataset(str(ds_dir)), train_indices=train_indices)
    return jt


def _port_trainer(cfg_kw, ds_dir, jt, train_indices=None):
    pt = SLTrainer(SLConfig(**cfg_kw), "se_resnet", {**TINY, "dtype": "float32"},
                   D.SLDataset(str(ds_dir)), train_indices=train_indices, device="cpu")
    pt.model.load_state_dict(flax_to_torch(jax.device_get(jt.state.params),
                                           jax.device_get(jt.state.batch_stats)))
    return pt


@pytest.mark.parametrize("case", ["one_epoch", "past_the_horizon"])
def test_sl_training_matches_jax(tmp_path, case):
    """29 positions, batches of 8 (3 steps an epoch, a tail of 5 dropped).
    one_epoch: epochs=2 in the config, one run (the schedule half way).
    past_the_horizon: a 19-position training split, epochs=1, two runs:
    the step count passes the decay horizon and the rate stays at its
    floor. Per step: losses and the learning rate; at the end: every
    parameter and BatchNorm statistic."""
    ds_dir = _dataset(tmp_path / "ds", 29, seed=0)
    if case == "one_epoch":
        cfg_kw, idx, runs = dict(batch_size=8, epochs=2, learning_rate=1e-3, seed=3), None, 1
    else:
        idx = np.random.default_rng(1).permutation(29)[:19]
        cfg_kw, runs = dict(batch_size=8, epochs=1, learning_rate=1e-3, seed=4), 2
    jt = _jax_trainer(cfg_kw, ds_dir, idx)
    pt = _port_trainer(cfg_kw, ds_dir, jt, idx)

    jax_steps = []
    step = jt._step

    def recorded(state, batch):
        new_state, m = step(state, batch)
        jax_steps.append({k: float(v) for k, v in m.items()})
        return new_state, m

    jt._step = recorded
    ours = []
    with jax.disable_jit():  # op by op, as tests/test_torch_training.py runs the update
        for _ in range(runs):
            jm = jt.train_epoch()
            tm = pt.train_epoch()
            ours += pt.step_metrics
            assert tm["batches"] == jm["batches"]
            for k in ("policy_loss", "value_loss", "score_loss"):
                np.testing.assert_allclose(tm[k], jm[k], rtol=1e-3, atol=1e-6, err_msg=k)
    n_train = 29 if idx is None else len(idx)
    horizon = cfg_kw["epochs"] * max(n_train // 8, 1)
    schedule = optax.cosine_decay_schedule(cfg_kw["learning_rate"], horizon, alpha=0.01)
    assert len(ours) == len(jax_steps) == runs * (n_train // 8) >= 3
    if case == "past_the_horizon":
        assert len(ours) > horizon
    for i, (o, j) in enumerate(zip(ours, jax_steps)):
        for k in ("policy_loss", "value_loss", "score_loss"):
            np.testing.assert_allclose(o[k], j[k], rtol=1e-3, atol=1e-6, err_msg=f"{k} {i}")
        np.testing.assert_allclose(o["learning_rate"], float(schedule(i)), rtol=1e-6,
                                   err_msg=f"lr {i}")
    want = flax_to_torch(jax.device_get(jt.state.params), jax.device_get(jt.state.batch_stats))
    sd = pt.model.state_dict()
    assert want.keys() == sd.keys()
    for k, v in want.items():
        np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=1e-3, atol=2e-6, err_msg=k)


def test_cosine_schedule_equals_optax_and_clamps():
    schedule = optax.cosine_decay_schedule(2e-3, 7, alpha=0.05)
    for count in range(12):
        np.testing.assert_allclose(cosine_decay_lr(2e-3, 7, 0.05, count),
                                   float(schedule(count)), rtol=1e-6)
    assert cosine_decay_lr(2e-3, 7, 0.05, 11) == cosine_decay_lr(2e-3, 7, 0.05, 7)


def test_evaluate_matches_jax_with_a_tie_at_the_fifth_logit(tmp_path):
    """policy_conv2 zeroed and its bias tied at the maximum in two move
    types: 162 logits share the largest value, so every target in those
    move types counts for top-5 (the JAX definition: logit >= the 5th
    largest), which top-k membership would not give."""
    ds_dir = tmp_path / "ds"
    rng = np.random.default_rng(5)
    n = 24
    obs = (rng.random((n, 4050)) < 0.15).astype(np.float32)
    slots = np.where(np.arange(n) % 2 == 0, rng.choice([17, 90], n), rng.integers(0, 139, n))
    pol = rng.integers(0, 81, n) * 139 + slots
    ds_dir.mkdir()
    D.write_shard(ds_dir / "shard_00000.bin", obs, pol, rng.integers(0, 3, n),
                  (rng.normal(size=n) * 0.3).astype(np.float32))
    D.write_meta(ds_dir, [n])
    cfg_kw = dict(batch_size=8, epochs=1, seed=2)
    jt = _jax_trainer(cfg_kw, ds_dir)
    params = jax.device_get(jt.state.params)
    bias = rng.normal(size=139).astype(np.float32)
    bias[[17, 90]] = bias.max() + 1.0
    params["policy_conv2"]["kernel"] = np.zeros_like(params["policy_conv2"]["kernel"])
    params["policy_conv2"]["bias"] = bias
    jt.state = jt.state.replace(params=jax.tree.map(jnp.asarray, params))
    pt = _port_trainer(cfg_kw, ds_dir, jt)

    idx = np.arange(n)[::-1].copy()
    with jax.disable_jit():
        want = jt.evaluate(idx)
    got = pt.evaluate(idx)
    assert got["positions"] == want["positions"] == n
    for k in ("policy_top1", "policy_top5", "value_acc"):
        assert got[k] == want[k], k
    for k in ("policy_nll", "score_mse"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    in_tied = np.isin(pol % 139, [17, 90])
    assert got["policy_top5"] == in_tied.mean() >= 0.5
    with pytest.raises(ValueError, match="split"):
        pt.evaluate(np.arange(5))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_recomputed_sl_step_equals_the_plain_step(tmp_path, monkeypatch, dtype):
    """Steps above RECOMPUTE_ABOVE rows recompute each trunk block in the
    backward. With the threshold lowered below the batch, a recomputed epoch
    (3 steps of 8 rows) equals the plain epoch bit for bit: the three losses
    of every step, every parameter and every BatchNorm statistic. Each
    BatchNorm moves its statistics once a step (an update is two in-place
    ops, mul_ and add_, each a version bump of the buffer), while the
    blocks start twice a step (the forward and the recompute, which stops
    once it has what the backward needs)."""
    from keisei_tpu_torch.models.se_resnet import FlaxBatchNorm
    from keisei_tpu_torch.sl import trainer as T

    ds_dir = _dataset(tmp_path / "ds", 24, seed=2)
    runs = {}
    for recompute in (False, True):
        monkeypatch.setattr(T, "RECOMPUTE_ABOVE", 4 if recompute else 8)
        tr = SLTrainer(SLConfig(batch_size=8, epochs=1, seed=5), "se_resnet",
                       {**TINY, "dtype": dtype}, D.SLDataset(str(ds_dir)), device="cpu")
        bns = [m for m in tr.model.modules() if isinstance(m, FlaxBatchNorm)]
        before = [(bn.running_mean._version, bn.running_var._version) for bn in bns]
        calls = []
        tr.model.block0.register_forward_pre_hook(lambda *_: calls.append(1))
        tr.train_epoch()
        steps = len(tr.step_metrics)
        assert steps == 3
        for bn, (vm, vv) in zip(bns, before):
            assert bn.running_mean._version - vm == bn.running_var._version - vv == 2 * steps
        assert len(calls) == (2 if recompute else 1) * steps
        runs[recompute] = (tr.step_metrics, tr.model.state_dict())
    (plain_m, plain_sd), (re_m, re_sd) = runs[False], runs[True]
    for a, b in zip(plain_m, re_m):
        for k in ("policy_loss", "value_loss", "score_loss"):
            assert a[k] == b[k], k
    assert plain_sd.keys() == re_sd.keys()
    for k, v in plain_sd.items():
        assert torch.equal(v, re_sd[k]), k


# -- the corpus generator ----------------------------------------------------------------


def test_generated_corpus_equals_the_jax_scripts_and_parses_the_same(tmp_path, monkeypatch):
    """The port's generator writes the CSA files scripts/generate_sl_corpus.py
    writes from the same seed, byte for byte (the same engine games, policy
    and Gumbel draws); they parse to equal records through both CSA
    parsers, and each game's outcome is the one its termination gives (a
    win by the last mover, a loss by perpetual check, a draw)."""
    log = []
    stats = generate_corpus(str(tmp_path / "port"), games=4, envs=4, max_ply=32,
                            games_per_file=3, seed=1, device="cpu", game_log=log)
    script = runpy.run_path(str(REPO / "scripts" / "generate_sl_corpus.py"), run_name="jax")
    monkeypatch.setattr(sys, "argv", [
        "generate_sl_corpus.py", "--games", "4", "--envs", "4", "--max-ply", "32",
        "--games-per-file", "3", "--seed", "1", "--out", str(tmp_path / "jax"), "--cpu"])
    script["main"]()
    files = sorted((tmp_path / "port").glob("*.csa"))
    assert [f.name for f in files] == sorted(f.name for f in (tmp_path / "jax").glob("*.csa"))
    for f in files:
        assert f.read_bytes() == (tmp_path / "jax" / f.name).read_bytes(), f.name
    assert stats["games"] == len(log) >= 4 and len(files) == 2
    ours = [r for f in files for r in PAR.CSAParser().parse(f)]
    theirs = [r for f in files for r in JPAR.CSAParser().parse(f)]
    assert len(ours) == len(theirs) == len(log)
    for o, t, (term, reason, reward, plies) in zip(ours, theirs, log):
        assert [m.move_usi for m in o.moves] == [m.move_usi for m in t.moves]
        assert (o.outcome.value, o.metadata, o.start_sfen) == (
            t.outcome.value, t.metadata, t.start_sfen)
        assert len(o.moves) == plies
        last_mover_black = plies % 2 == 1
        if reward > 0:
            want = PAR.GameOutcome.WIN_BLACK if last_mover_black else PAR.GameOutcome.WIN_WHITE
        elif reward < 0:
            want = PAR.GameOutcome.WIN_WHITE if last_mover_black else PAR.GameOutcome.WIN_BLACK
        else:
            want = PAR.GameOutcome.DRAW
        assert o.outcome == want, (term, reason, reward)
        assert term == {TY.MAX_MOVES: "%CHUDAN", TY.CHECKMATE: "%TSUMI",
                        TY.PERPETUAL_CHECK: "%ILLEGAL_MOVE", TY.REPETITION: "%SENNICHITE",
                        TY.IMPASSE: "%JISHOGI" if reward == 0 else "%TSUMI"}[reason]


def test_busy_share_counts_overlapping_device_spans_once():
    """The smoke's busy share (utils/timing.py:device_busy) is the union of
    the device's spans: overlaps count once, gaps not at all."""
    assert union_us([]) == 0.0
    assert union_us([(5.0, 6.0), (0.0, 2.0), (1.0, 3.0), (5.5, 5.7)]) == 4.0
    assert union_us([(0.0, 10.0), (2.0, 3.0)]) == 10.0

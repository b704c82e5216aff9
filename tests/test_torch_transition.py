"""The SL -> RL warm start and the trainer's checkpoints: `sl_to_rl` (epoch 0,
`sl_final`'s weights bit for bit, a fresh optimizer, the trainer's own
generator, then a finite RL epoch), pinned over a stale RL checkpoint,
`sl_final` kept by pruning, the refusals (bad model params before any
directory exists, an empty dataset, an explicit resume path without meta,
the scalar contract), `load_checkpoint(skip_optimizer=True)`, and the
asynchronous periodic saves: the same files as blocking saves, taken from
a copy of the state, a failed write raised at the next drain.

Tiny se_resnet models on the CPU, as the JAX package's own SL tests use
tiny models."""

import dataclasses
import os
import threading
import types

import numpy as np
import pytest
import torch

from keisei_tpu_torch.models.registry import build_model
from keisei_tpu_torch.sl.dataset import SLDataset, write_meta, write_shard
from keisei_tpu_torch.sl.trainer import SLConfig, SLTrainer
from keisei_tpu_torch.training import loop as L
from keisei_tpu_torch.training.checkpoint import (STATE_NAME, load_checkpoint, load_meta,
                                                  save_checkpoint)
from keisei_tpu_torch.training.config import config_from_dict
from keisei_tpu_torch.training.loop import SelfPlayTrainer
from keisei_tpu_torch.training.transition import sl_to_rl

torch.set_num_threads(2)

TINY = {"num_blocks": 2, "channels": 16, "global_pool_channels": 8, "se_reduction": 4}


def _rl_cfg(tmp_path, keep=5, **training):
    return config_from_dict({
        "model": {"architecture": "se_resnet", "params": dict(TINY)},
        "training": {
            "num_games": 4, "max_ply": 16, "steps_per_epoch": 4,
            "checkpoint_dir": str(tmp_path / "ckpt"), "checkpoint_keep": keep,
            "algorithm_params": {"batch_size": 8, "epochs_per_batch": 1},
            **training,
        },
    })


@pytest.fixture
def sl_data(tmp_path):
    rng = np.random.default_rng(0)
    out = tmp_path / "shards"
    out.mkdir()
    n = 20
    write_shard(out / "shard_00000.bin", (rng.random((n, 4050)) < 0.15).astype(np.float32),
                rng.integers(0, 11259, n), rng.integers(0, 3, n),
                (rng.normal(size=n) * 0.3).astype(np.float32))
    write_meta(out, [n])
    return str(out)


def _saved_model(path: str) -> dict:
    return torch.load(os.path.join(path, STATE_NAME), weights_only=True)["model"]


def _assert_state_equal(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_sl_to_rl_warm_starts_from_sl_final(tmp_path, sl_data):
    cfg = _rl_cfg(tmp_path)
    rl = sl_to_rl(sl_data_dir=sl_data, sl_epochs=2, rl_config=cfg, sl_batch_size=4,
                  device="cpu")
    sl_final = tmp_path / "ckpt" / "sl_final"
    assert load_meta(str(sl_final))["phase"] == "sl" and rl.epoch == 0
    _assert_state_equal(rl.model.state_dict(), _saved_model(str(sl_final)))
    assert len(rl.optimizer.state) == 0
    assert rl.optimizer.param_groups[0]["lr"] == cfg.algorithm_params.learning_rate
    own = torch.Generator().manual_seed(cfg.training.seed)
    assert torch.equal(rl.generator.get_state(), own.get_state())
    em = rl.run_epoch()
    assert np.isfinite([em.policy_loss, em.value_loss, em.score_loss]).all()
    assert len(rl.optimizer.state) > 0


def test_sl_to_rl_wins_over_a_stale_rl_checkpoint(tmp_path, sl_data):
    cfg = _rl_cfg(tmp_path)
    old = SelfPlayTrainer(cfg, device="cpu")
    old.run_epoch()
    old.run_epoch()
    old.save()
    assert old.latest_checkpoint().endswith("epoch_000002")
    rl = sl_to_rl(sl_data_dir=sl_data, sl_epochs=1, rl_config=cfg, sl_batch_size=4,
                  device="cpu")
    assert rl.epoch == 0
    _assert_state_equal(rl.model.state_dict(),
                        _saved_model(str(tmp_path / "ckpt" / "sl_final")))
    assert len(rl.optimizer.state) == 0


def test_sl_final_survives_pruning(tmp_path, sl_data):
    rl = sl_to_rl(sl_data_dir=sl_data, sl_epochs=1, rl_config=_rl_cfg(tmp_path, keep=1),
                  sl_batch_size=4, device="cpu")
    for _ in range(3):
        rl.run_epoch()
        rl.save()
    names = sorted(p.name for p in (tmp_path / "ckpt").iterdir())
    assert names == ["epoch_000003", "sl_final"]


def test_sl_to_rl_rejects_bad_model_params_before_any_directory(tmp_path):
    cfg = _rl_cfg(tmp_path)
    bad = dataclasses.replace(cfg, model=types.SimpleNamespace(
        architecture="se_resnet", params={**TINY, "bogus_knob": 3}))
    with pytest.raises(ValueError, match="unknown model params"):
        sl_to_rl(sl_data_dir=str(tmp_path / "nonexistent"), sl_epochs=1, rl_config=bad,
                 device="cpu")
    assert not (tmp_path / "ckpt").exists()


def test_sl_to_rl_rejects_an_empty_dataset(tmp_path):
    empty = tmp_path / "empty"
    empty.mkdir()
    write_meta(empty, [], placeholder=False)
    with pytest.raises(ValueError, match="no SL positions"):
        sl_to_rl(sl_data_dir=str(empty), sl_epochs=1, rl_config=_rl_cfg(tmp_path),
                 device="cpu")


def test_explicit_resume_without_meta_raises(tmp_path):
    (tmp_path / "nothing").mkdir()
    with pytest.raises(FileNotFoundError, match="keisei_meta.json"):
        SelfPlayTrainer(_rl_cfg(tmp_path), device="cpu", resume_from=str(tmp_path / "nothing"))


def test_scalar_contract_raises(sl_data):
    with pytest.raises(NotImplementedError, match="item 7"):
        SLTrainer(SLConfig(), "mlp", {"hidden_sizes": [8]}, SLDataset(sl_data), device="cpu")


def test_skip_optimizer_loads_the_weights_only(tmp_path):
    """The saved optimizer has another structure (no state at all here);
    the live optimizer's state and the generator stay as they were."""
    src, _ = build_model("se_resnet", TINY)
    save_checkpoint(str(tmp_path / "c"), src, torch.optim.SGD(src.parameters(), lr=0.1),
                    epoch=0, architecture="se_resnet", generator=torch.Generator().manual_seed(9),
                    extra_meta={"phase": "sl"})
    dst, _ = build_model("se_resnet", TINY)
    opt = torch.optim.Adam(dst.parameters())
    dst(torch.zeros(2, 50, 9, 9)).policy_logits.sum().backward()
    opt.step()
    opt_before = {i: {k: v.clone() for k, v in s.items()} for i, s in opt.state.items()}
    gen = torch.Generator().manual_seed(1)
    torch.rand(3, generator=gen)
    gen_before = gen.get_state()
    load_checkpoint(str(tmp_path / "c"), dst, opt, gen, architecture="se_resnet",
                    skip_optimizer=True)
    _assert_state_equal(dst.state_dict(), src.state_dict())
    assert torch.equal(gen.get_state(), gen_before)
    assert opt.state.keys() == opt_before.keys()
    for i, s in opt.state.items():
        for k, v in s.items():
            assert torch.equal(v, opt_before[i][k])


# -- asynchronous periodic saves -------------------------------------------------------


def _payload(path):
    p = torch.load(os.path.join(path, STATE_NAME), weights_only=True)
    return p, load_meta(path)


def test_async_saves_write_what_blocking_saves_write(tmp_path):
    """Two trainers from one seed, saves every epoch, one asynchronous: after
    the drain every epoch's checkpoint holds the same model, optimizer,
    generator and meta."""
    runs = {}
    for mode in (False, True):
        cfg = _rl_cfg(tmp_path / str(mode), checkpoint_interval=1, async_checkpoint=mode)
        trainer = SelfPlayTrainer(cfg, device="cpu")
        trainer.run_epoch()
        trainer.run_epoch()
        trainer._drain_checkpoint()
        runs[mode] = tmp_path / str(mode) / "ckpt"
    assert sorted(os.listdir(runs[True])) == sorted(os.listdir(runs[False])) == [
        "epoch_000001", "epoch_000002"]
    for name in ("epoch_000001", "epoch_000002"):
        (a, ma), (b, mb) = _payload(str(runs[True] / name)), _payload(str(runs[False] / name))
        assert ma == mb
        _assert_state_equal(a["model"], b["model"])
        assert torch.equal(a["generator"], b["generator"])
        assert a["optimizer"]["param_groups"] == b["optimizer"]["param_groups"]
        for i, s in b["optimizer"]["state"].items():
            for k, v in s.items():
                assert torch.equal(a["optimizer"]["state"][i][k], v), (name, i, k)


def test_async_save_writes_a_copy_taken_before_it_returns(tmp_path, monkeypatch):
    """The writer is held until the live parameters have been changed in
    place: the checkpoint still holds the values of the save."""
    release = threading.Event()
    real = L.write_checkpoint

    def held(*args, **kwargs):
        release.wait(timeout=30)
        real(*args, **kwargs)

    monkeypatch.setattr(L, "write_checkpoint", held)
    trainer = SelfPlayTrainer(_rl_cfg(tmp_path), device="cpu")
    want = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    path = trainer.save(blocking=False)
    with torch.no_grad():
        for p in trainer.model.parameters():
            p.add_(1.0)
    release.set()
    trainer.close()
    _assert_state_equal(_saved_model(path), want)


def test_a_failed_async_write_raises_at_the_next_drain(tmp_path, monkeypatch):
    def broken(*args, **kwargs):
        raise OSError("disk full")

    monkeypatch.setattr(L, "write_checkpoint", broken)
    trainer = SelfPlayTrainer(_rl_cfg(tmp_path), device="cpu")
    trainer.save(blocking=False)
    with pytest.raises(OSError, match="disk full"):
        trainer.save(blocking=False)  # waits for the write before it first
    assert trainer._ckpt_future is None
    trainer.save(blocking=False)
    with pytest.raises(OSError, match="disk full"):
        trainer.close()


@pytest.mark.parametrize("what", ["GameEncoder", "prepare_sl_data", "SLTrainer", "sl_to_rl",
                                  "generate_corpus"])
def test_sl_entry_points_default_to_the_card(monkeypatch, tmp_path, sl_data, what):
    """Built or called with no device, every entry point of the SL path
    resolves to the card, and raises on a machine without CUDA instead of
    running on the CPU."""
    from keisei_tpu_torch.scripts.generate_sl_corpus import generate_corpus
    from keisei_tpu_torch.sl.encode import GameEncoder
    from keisei_tpu_torch.sl.prepare import prepare_sl_data

    (tmp_path / "games").mkdir()
    (tmp_path / "games" / "g.sfen").write_text("result:draw\nstartpos\n7g7f\n3c3d\n")
    calls = {
        "GameEncoder": lambda: GameEncoder(),
        "prepare_sl_data": lambda: prepare_sl_data([str(tmp_path / "games")],
                                                   str(tmp_path / "out"), min_ply=1),
        "SLTrainer": lambda: SLTrainer(SLConfig(), "se_resnet", TINY, SLDataset(sl_data)),
        "sl_to_rl": lambda: sl_to_rl(sl_data_dir=sl_data, sl_epochs=1,
                                     rl_config=_rl_cfg(tmp_path)),
        "generate_corpus": lambda: generate_corpus(str(tmp_path / "corpus"), games=1, envs=1),
    }
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[what]()

"""The Dynamic-entry update path against the JAX package's DynamicTrainer:
record_rollout (the mover filter, the per-match cap, the negamax mirror
of terminal outcomes, the float16 round trip of the observations) and
_build_batch (newest rows, zero-weight padding, W/D/L categories) equal
to JAX's; one update with JAX's permutations handed over, JAX run op by op
(`jax.disable_jit()`, as the self-play update's test runs it): losses
within 1e-6, parameters and BatchNorm statistics within 1e-5. The gates,
the circuit breaker, the Adam moments' LRU and the order of a failed
install get behavioural tests.

The rollouts are JAX MatchRollouts made from a seeded numpy generator with
the structure the engine gives them: movers alternate within a game and a
fresh game starts with Black, rewards sit on the last mover's row, games
end by a result or by truncation (reward 0). Observations are arbitrary
f32 values, so the f16 rounding shows.
"""

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keisei_tpu.league import dynamic_trainer as JDT
from keisei_tpu.league.config import DynamicConfig as JaxDynamicConfig
from keisei_tpu.league.match import MatchRollout as JaxRollout
from keisei_tpu.league.store import OpponentStore as JaxStore
from keisei_tpu.models.registry import build_model as jax_build_model
from keisei_tpu_torch.league import dynamic_trainer as DT
from keisei_tpu_torch.league.config import DynamicConfig
from keisei_tpu_torch.league.match import MatchRollout
from keisei_tpu_torch.league.store import OpponentStore, Role
from keisei_tpu_torch.models.convert import flax_to_torch

torch.set_num_threads(2)

TINY = {"num_blocks": 2, "channels": 16, "global_pool_channels": 8, "se_reduction": 4}
C, A = 50, 11259


def _rollout(seed: int, T: int = 14, N: int = 6):
    """(JAX MatchRollout, the same as the port's) from a seeded generator."""
    rng = np.random.default_rng(seed)
    mover = np.zeros((T, N), np.int32)
    dones = np.zeros((T, N), bool)
    rewards = np.zeros((T, N), np.float32)
    for n in range(N):
        ply = int(rng.integers(0, 3))  # envs start mid-game too
        for t in range(T):
            mover[t, n] = ply % 2
            if rng.random() < 0.15 and ply > 0:
                dones[t, n] = True
                rewards[t, n] = rng.choice([-1.0, 0.0, 1.0])
                ply = 0
            else:
                ply += 1
    fields = dict(
        obs=rng.normal(size=(T, N, C, 81)).astype(np.float32),
        actions=rng.integers(0, A, size=(T, N)).astype(np.int32),
        legal_masks=rng.random((T, N, A)) < 0.02,
        rewards=rewards, dones=dones,
        captured=np.where(rng.random((T, N)) < 0.2, rng.integers(0, 7, (T, N)), 255
                          ).astype(np.uint8),
        term_reason=np.where(dones, 1, 0).astype(np.uint8),
        mover_color=mover,
        a_color=(np.arange(N) % 2).astype(np.int32),
    )
    jr = JaxRollout(**{k: jnp.asarray(v) for k, v in fields.items()})
    tr = MatchRollout(**{k: torch.from_numpy(v) for k, v in fields.items()})
    return jr, tr


def _stores(tmp_path):
    jstore = JaxStore(str(tmp_path / "jax.db"), str(tmp_path / "jax"))
    store = OpponentStore(str(tmp_path / "port.db"), str(tmp_path / "port"), device="cpu")
    return jstore, store


@pytest.mark.parametrize("batch_cap,depth", [(32, 4), (128, 2)], ids=["capped", "padded"])
def test_buffers_and_batch_equal_jax(tmp_path, batch_cap, depth):
    """Three matches recorded for an entry on side a and one on side b:
    the host buffers equal JAX's field by field (obs after its f16 round
    trip, which differs from the f32 input), and so does the batch
    (`_build_batch`: JAX's packed masks unpacked)."""
    jstore, store = _stores(tmp_path)
    jt = JDT.DynamicTrainer(jstore, None, JaxDynamicConfig(max_buffer_depth=depth),
                            batch_cap=batch_cap)
    tt = DT.DynamicTrainer(store, None, DynamicConfig(max_buffer_depth=depth),
                           batch_cap=batch_cap)
    for seed, side in ((0, "a"), (1, "b"), (2, "a"), (3, "a")):
        jr, tr = _rollout(seed)
        jt.record_rollout(7, jr, side)
        tt.record_rollout(7, tr, side)
    assert tt._match_counts == jt._match_counts == {7: 4}
    assert len(tt._buffers[7]) == len(jt._buffers[7]) == min(depth, 4)
    rounded = False
    for got, want in zip(tt._buffers[7], jt._buffers[7]):
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_array_equal(got[k].reshape(want[k].shape), want[k], err_msg=k)
        rounded |= bool((got["obs"] != got["obs"].astype(np.float16).astype(np.float32)).any())
    assert not rounded, "buffered obs must be f16-representable"
    raw = _rollout(3)[1].obs.numpy()
    assert (raw != raw.astype(np.float16).astype(np.float32)).any()  # so f16 rounded them
    assert any(c["dones"].any() for c in tt._buffers[7])

    jb, tb = jt._build_batch(7), tt._build_batch(7)
    assert tb["obs"].dtype == torch.float16 and tb["obs"].shape == (batch_cap, C, 9, 9)
    np.testing.assert_array_equal(tb["obs"].numpy(), np.asarray(jb["obs"]))
    masks = np.unpackbits(np.asarray(jb["masks"]), axis=1, bitorder="little")[:, :A]
    np.testing.assert_array_equal(tb["masks"].numpy(), masks.astype(bool))
    for k in ("actions", "rewards", "dones", "weights", "value_cats"):
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]), err_msg=k)
    weights = tb["weights"].numpy()
    assert (weights == 0).any() == (batch_cap == 128)


def test_light_rollout_only_counts(tmp_path):
    _, store = _stores(tmp_path)
    tt = DT.DynamicTrainer(store, None, DynamicConfig())
    _, tr = _rollout(0)
    tt.record_rollout(3, dataclasses.replace(tr, obs=None, legal_masks=None), "a")
    assert tt._match_counts == {3: 1} and 3 not in tt._buffers
    assert tt._build_batch(3) is None


def _jax_f32_variables():
    jmodel, _ = jax_build_model("se_resnet", {**TINY, "dtype": jnp.float32})
    v = jax.device_get(jax.jit(lambda k: jmodel.init(k, jnp.zeros((2, C, 9, 9)),
                                                     train=False))(jax.random.key(5)))
    rng = np.random.default_rng(9)
    stats = jax.tree_util.tree_map_with_path(
        lambda p, x: (rng.uniform(0.5, 1.5, x.shape) if "var" in jax.tree_util.keystr(p)
                      else rng.normal(size=x.shape) * 0.1).astype(np.float32),
        v["batch_stats"])
    return jmodel, {"params": v["params"], "batch_stats": stats}


def test_one_update_matches_jax(tmp_path, monkeypatch):
    """One Dynamic update of an entry stored as a bf16 snapshot (cast to
    f32 on both sides): the same buffered matches, JAX's per-epoch
    permutations handed to the port, float32 models. Policy and value
    losses within 1e-6; every updated parameter and BatchNorm statistic
    within 1e-5; the store then holds the new generation on both sides.

    Two epochs of four 16-row minibatches at lr 5e-4: Adam moves a
    coordinate by about lr a step whatever its gradient's size, so a
    coordinate whose gradient is at the level of the two frameworks'
    rounding differences can take another step on each side (with 32-row
    minibatches of the same rows one of 2,304 conv weights ended 3.7e-5
    apart)."""
    jmodel, variables = _jax_f32_variables()
    jbf16 = jax.tree.map(lambda x: jnp.asarray(x).astype(jnp.bfloat16), variables)
    tbf16 = {k: v.to(torch.bfloat16) for k, v in
             flax_to_torch(variables["params"], variables["batch_stats"]).items()}
    params = {**TINY, "dtype": "float32"}
    cfg = dict(update_every_matches=2, update_epochs_per_batch=2, lr_scale=0.5)
    jstore, store = _stores(tmp_path)
    je = jstore.add_entry(jbf16, architecture="se_resnet", model_params=params,
                          created_epoch=0, role=Role.DYNAMIC)
    te = store.add_entry(tbf16, architecture="se_resnet", model_params=params,
                         created_epoch=0, role=Role.DYNAMIC)
    jt = JDT.DynamicTrainer(jstore, jmodel, JaxDynamicConfig(**cfg), learner_lr=1e-3,
                            batch_cap=64, step_batch=16)
    tt = DT.DynamicTrainer(store, None, DynamicConfig(**cfg), learner_lr=1e-3,
                           batch_cap=64, step_batch=16)
    for seed, side in ((4, "a"), (5, "b")):
        jr, tr = _rollout(seed)
        jt.record_rollout(je.id, jr, side)
        tt.record_rollout(te.id, tr, side)

    seen = {}
    make = JDT._make_update_fn

    def recording_make(*args, **kwargs):
        fn = make(*args, **kwargs)

        def update(*a):
            out = fn(*a)
            seen["jax"] = out
            return out

        return update

    monkeypatch.setattr(JDT, "_make_update_fn", recording_make)
    cap = 64
    assert DT._plan_chunks(cap, 16) == JDT._plan_chunks(cap, 16) == (4, 16)
    assert DT._plan_chunks(100, 32) == JDT._plan_chunks(100, 32) == (4, 25)
    keys = jax.random.split(jax.random.key(3), cfg["update_epochs_per_batch"])
    tt.next_perms = [torch.from_numpy(np.asarray(jax.random.permutation(k, cap)).astype(
        np.int64)) for k in keys]
    with jax.disable_jit():
        assert jt.maybe_update(jstore.get_entry(je.id), seed=3)
    assert tt.maybe_update(store.get_entry(te.id), seed=3)
    assert tt.next_perms is None and tt._error_counts[te.id] == 0

    jvars, _, jm = seen["jax"]
    for k in ("policy_loss", "value_loss"):
        assert abs(tt.last_metrics[k] - float(jm[k])) <= 1e-6, (k, tt.last_metrics[k], jm[k])
    assert tt.last_metrics["value_loss"] > 0
    want = flax_to_torch(jax.device_get(jvars["params"]), jax.device_get(jvars["batch_stats"]))
    got = store.load_variables_cached(store.get_entry(te.id))
    assert store.get_entry(te.id).update_count == jstore.get_entry(je.id).update_count == 1
    assert got.keys() == want.keys()
    moved = 0
    for k in want:
        assert got[k].dtype == torch.float32, k
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0, atol=1e-5,
                                   err_msg=k)
        moved += not torch.equal(got[k], tbf16[k].float())
    assert moved > len(want) // 2


def _port_trainer(tmp_path, **cfg):
    store = OpponentStore(str(tmp_path / "g.db"), str(tmp_path / "g"), device="cpu")
    entry = store.add_entry(
        {k: v for k, v in _tiny_state_dict().items()}, architecture="se_resnet",
        model_params=TINY, created_epoch=0, role=Role.DYNAMIC)
    return store, entry, DT.DynamicTrainer(store, None, DynamicConfig(**cfg), batch_cap=32,
                                           step_batch=16)


def _tiny_state_dict():
    from keisei_tpu_torch.models.registry import build_model

    torch.manual_seed(0)
    return build_model("se_resnet", TINY)[0].state_dict()


def test_gates(tmp_path):
    """The cadence, the per-round budget, the rate limit and the
    architecture gate."""
    store, entry, tt = _port_trainer(tmp_path, update_every_matches=2,
                                     max_updates_per_round=1, max_updates_per_minute=2)
    _, tr = _rollout(0)
    tt.record_rollout(entry.id, tr, "a")
    assert not tt.should_update(entry.id)  # 1 match of 2
    tt.record_rollout(entry.id, tr, "b")
    assert tt.should_update(entry.id)
    tt.architecture = "resnet"
    assert not tt.maybe_update(store.get_entry(entry.id))  # another architecture
    tt.architecture = "se_resnet"
    assert tt.maybe_update(store.get_entry(entry.id))
    assert store.get_entry(entry.id).update_count == 1
    assert not tt.should_update(entry.id)  # the round's budget is spent
    tt.begin_round()
    assert tt.should_update(entry.id)
    tt._recent_update_times.append(time.monotonic())
    assert not tt.should_update(entry.id)  # 2 updates in the last minute


def test_circuit_breaker(tmp_path, monkeypatch):
    """Consecutive failures disable the entry (in the store too); the
    global error window then stops every entry."""
    store, entry, tt = _port_trainer(tmp_path, update_every_matches=1,
                                     max_consecutive_errors=2, global_error_threshold=3)
    _, tr = _rollout(0)
    tt.record_rollout(entry.id, tr, "a")

    def boom(entry_id):
        raise RuntimeError("device lost")

    monkeypatch.setattr(tt, "_build_batch", boom)
    assert not tt.maybe_update(store.get_entry(entry.id))
    assert tt._error_counts[entry.id] == 1 and entry.id not in tt.disabled_entries()
    assert not tt.maybe_update(store.get_entry(entry.id))
    assert entry.id in tt.disabled_entries()
    assert not store.get_entry(entry.id).training_enabled
    tt._match_counts[99] = 1
    assert tt.should_update(99)
    tt._recent_errors.append(time.monotonic())
    assert not tt.should_update(99)  # 3 errors in the window: globally off


def test_failed_install_keeps_the_moments(tmp_path, monkeypatch):
    """store.update_weights comes before the moments are kept: when it
    raises, the entry keeps no moments from the discarded update and its
    flush counter does not move; the next update succeeds from scratch."""
    store, entry, tt = _port_trainer(tmp_path, update_every_matches=1)
    _, tr = _rollout(0)
    tt.record_rollout(entry.id, tr, "a")
    real = store.update_weights

    def failing(*args, **kwargs):
        raise RuntimeError("previous async weight flush failed")

    monkeypatch.setattr(store, "update_weights", failing)
    assert not tt.maybe_update(store.get_entry(entry.id))
    assert entry.id not in tt._opt_states and entry.id not in tt._updates_since_flush
    assert tt._error_counts[entry.id] == 1
    monkeypatch.setattr(store, "update_weights", real)
    assert tt.maybe_update(store.get_entry(entry.id))
    assert int(tt._opt_states[entry.id]["count"]) == 2 * 2  # 2 epochs x 2 minibatches
    assert tt._updates_since_flush[entry.id] == 1 and tt._error_counts[entry.id] == 0


def test_moments_lru_demotes_to_host(tmp_path, monkeypatch):
    """optimizer_device_cache=2 keeps the two most recently trained
    entries' moments where they were trained and demotes the coldest to
    host memory; a cache of 0 demotes every update, no offload none."""
    demoted = []
    monkeypatch.setattr(DT, "_to", lambda tree, device: demoted.append(
        (tree["tag"], str(device))) or {**tree, "where": str(device)})
    _, _, tt = _port_trainer(tmp_path, optimizer_device_cache=2)
    for eid in (1, 2, 1, 3):
        tt._park_opt_state(eid, {"tag": eid})
    assert list(tt._opt_on_device) == [1, 3] and demoted == [(2, "cpu")]
    assert tt._opt_states[2]["where"] == "cpu" and "where" not in tt._opt_states[3]
    tt.drop_entry(1)
    assert list(tt._opt_on_device) == [3] and 1 not in tt._opt_states
    demoted.clear()
    _, _, t0 = _port_trainer(tmp_path / "0", optimizer_device_cache=0)
    t0._park_opt_state(5, {"tag": 5})
    assert demoted == [(5, "cpu")] and not t0._opt_on_device
    demoted.clear()
    _, _, t1 = _port_trainer(tmp_path / "1", offload_optimizer=False)
    t1._park_opt_state(6, {"tag": 6})
    assert demoted == [] and t1._opt_states[6] == {"tag": 6}

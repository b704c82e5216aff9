"""The port's league store, its cohort glue, frozen matches and the
gauntlet, against the JAX package.

The SQLite side is held row for row: the same operations through the
port's OpponentStore and the JAX package's give the same league rows, and
a league.db the port wrote reads back through `keisei_tpu.league.store`
and `keisei_tpu.db`. The weight side (torch.save of state dicts) is held
to its own contract: versioned paths, the pointer swing, the async flush,
the crash reconciliation, bf16 snapshots kept bf16, and a bf16 snapshot's
forward against the JAX forward on the same bf16 weights.
"""

import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keisei_tpu import db as jax_db
from keisei_tpu.league.store import OpponentStore as JaxStore
from keisei_tpu.models.registry import build_model as jax_build_model
from keisei_tpu_torch.league.config import GauntletConfig, HistoricalLibraryConfig
from keisei_tpu_torch.league.historical import HistoricalGauntlet, HistoricalLibrary
from keisei_tpu_torch.league.league_ops import (stack_cohort_variables,
                                                stacked_cohort_template)
from keisei_tpu_torch.league.match import ModelCache, make_match_runner, play_match
from keisei_tpu_torch.league.store import EntryStatus, OpponentStore, Role
from keisei_tpu_torch.models.convert import flax_to_torch
from keisei_tpu_torch.models.registry import build_model

torch.set_num_threads(2)

TINY = {"num_blocks": 1, "channels": 16, "global_pool_channels": 8, "se_reduction": 4}


def _state_dict(seed: int) -> dict:
    torch.manual_seed(seed)
    return build_model("se_resnet", TINY)[0].state_dict()


@pytest.fixture
def store(tmp_path):
    return OpponentStore(str(tmp_path / "league.db"), str(tmp_path / "league"),
                         cache_size=4, device="cpu")


def _add(store, sd, epoch=0, role=Role.RECENT_FIXED):
    return store.add_entry(sd, architecture="se_resnet", model_params=TINY,
                           created_epoch=epoch, role=role)


def _league_script(store, variables):
    """One sequence of league writes: entries, results, role moves, a
    retirement, Elo carry-forward."""
    a = _add(store, variables[0], 0, Role.RECENT_FIXED)
    b = _add(store, variables[1], 1, Role.DYNAMIC)
    c = _add(store, variables[2], 2, Role.FRONTIER_STATIC)
    store.record_result(a.id, b.id, epoch=3, wins_a=3, wins_b=1, draws=2,
                        match_type="training", k=32.0, elo_floor=500.0)
    store.record_result(c.id, a.id, epoch=4, wins_a=0, wins_b=2, draws=0,
                        role_elo_k={Role.FRONTIER_STATIC: 8.0, Role.DYNAMIC: 12.0,
                                    Role.RECENT_FIXED: 16.0})
    store.update_role(b.id, Role.FRONTIER_STATIC, reason="promoted")
    store.retire_entry(c.id, reason="review")
    store.set_protection(a.id, 3)
    store.carry_forward_elo(5)


def _rows(db_path, table):
    """A table's rows without wall-clock stamps and weight paths."""
    order = "entry_a_id, entry_b_id" if table == "head_to_head" else "id"
    rows = jax_db.connect(db_path).execute(f"SELECT * FROM {table} ORDER BY {order}")
    return [{k: r[k] for k in r.keys() if not k.endswith("_at") and k != "checkpoint_path"}
            for r in rows.fetchall()]


def test_the_port_writes_the_rows_the_jax_store_writes(tmp_path):
    port = OpponentStore(str(tmp_path / "port.db"), str(tmp_path / "pl"), device="cpu")
    _league_script(port, [_state_dict(i) for i in range(3)])

    jmodel, _ = jax_build_model("se_resnet", TINY)
    init = jax.jit(lambda k: jmodel.init(k, jnp.zeros((2, 50, 9, 9)), train=False))
    ref = JaxStore(str(tmp_path / "jax.db"), str(tmp_path / "jl"))
    _league_script(ref, [jax.device_get(init(jax.random.key(i))) for i in range(3)])

    for table in ("league_entries", "league_results", "league_transitions", "elo_history",
                  "head_to_head"):
        assert _rows(str(tmp_path / "port.db"), table) == \
            _rows(str(tmp_path / "jax.db"), table), table


def test_a_league_db_the_port_wrote_reads_back_through_the_jax_package(store, tmp_path):
    _league_script(store, [_state_dict(i) for i in range(3)])
    db_path = store.db_path
    ours = {e.id: e for e in store.list_entries()}
    theirs = JaxStore(db_path, str(tmp_path / "league")).list_entries()
    assert [e.id for e in theirs] == [e.id for e in store.list_entries()]
    for e in theirs:
        assert vars(e) == vars(ours[e.id])
        assert os.path.isfile(os.path.join(e.checkpoint_path, "state.pt"))
    data = jax_db.read_league_data(db_path)
    assert len(data["entries"]) == 3 and len(data["results"]) == 2
    assert {r["match_type"] for r in data["results"]} == {"training", "tournament"}
    assert len(jax_db.read_elo_history(db_path)) == 4 + 2  # 2 results x 2, + 2 active
    h2h = jax_db.read_head_to_head(db_path)
    assert sum(r["games"] for r in h2h) == 6 + 2


def test_weights_round_trip_versioned_flush_and_reconcile(store):
    sd0, sd1, sd2 = _state_dict(0), _state_dict(1), _state_dict(2)
    e = _add(store, sd0, role=Role.DYNAMIC)
    got = store.load_variables(e)
    assert got.keys() == sd0.keys() and all(torch.equal(got[k], sd0[k]) for k in sd0)

    gate = threading.Event()
    real_save = store._save_variables

    def slow_save(path, variables, meta=None):
        gate.wait(timeout=30)
        real_save(path, variables, meta)

    store._save_variables = slow_save
    store.update_weights(e.id, sd1, flush="async")
    store._cache.clear()  # a miss during the flush must read the pinned tree
    fresh = store.get_entry(e.id)
    assert fresh.update_count == 1 and fresh.checkpoint_path.endswith("weights")
    k = next(iter(sd1))
    assert torch.equal(store.load_variables_cached(fresh)[k], sd1[k])
    gate.set()
    store.wait_for_flushes()
    store._save_variables = real_save
    assert store.get_entry(e.id).checkpoint_path.endswith("weights-v1")

    store.update_weights(e.id, sd2, flush="sync")
    entry_dir = os.path.join(store.league_dir, str(e.id))
    assert sorted(os.listdir(entry_dir)) == ["weights-v1", "weights-v2"]  # one grace
    assert torch.equal(store.load_variables(store.get_entry(e.id))[k], sd2[k])

    # a bump whose flush was lost in a crash: reconciled to the committed v2
    store.bump_update_count(e.id)
    assert store.get_entry(e.id).update_count == 3
    store.reconcile_update_counts()
    assert store.get_entry(e.id).update_count == 2

    # a row stranded mid-add is swept
    jax_db.connect(store.db_path).execute(
        "INSERT INTO league_entries (display_name, architecture, model_params, "
        "checkpoint_path, created_epoch, status) VALUES ('', 'se_resnet', '{}', '', 0, "
        f"'{EntryStatus.MATERIALIZING}')").connection.commit()
    store.reconcile_update_counts()
    assert store.pool_size() == 1 and len(store.list_entries(status="materializing")) == 0


def test_bf16_snapshots_stay_bf16_and_the_cache_counts_their_bytes(store):
    sd = _state_dict(0)
    bf = {k: v.to(torch.bfloat16) if v.is_floating_point() else v for k, v in sd.items()}
    e16, e32 = _add(store, bf), _add(store, sd)
    loaded = store.load_variables(e16)
    assert {v.dtype for v in loaded.values()} == {torch.bfloat16}
    native32 = store.load_variables_cached(e32)
    cast16 = store.load_variables_cached(e32, dtype="bfloat16")
    assert {v.dtype for v in cast16.values()} == {torch.bfloat16}
    assert store._tree_nbytes(cast16) * 2 == store._tree_nbytes(native32)
    with store._lock:
        assert store._tree_bytes[(e32.id, 0, "bfloat16")] * 2 == \
            store._tree_bytes[(e32.id, 0, "native")]
    # natives go first once the byte budget binds
    store._cache_bytes = store._tree_nbytes(native32)
    store.load_variables_cached(e16, dtype=torch.bfloat16)
    assert all(key[2] == "bfloat16" for key in store._cache)

    stacked = stack_cohort_variables(store, [e32, e16, e32], sd, dtype=torch.bfloat16)
    template = stacked_cohort_template(sd, 3, dtype=torch.bfloat16)
    assert stacked.keys() == template.keys() == sd.keys()
    for k, v in stacked.items():
        assert v.shape == template[k].shape == (3,) + sd[k].shape
        assert v.dtype == template[k].dtype
        assert torch.equal(v[1], bf[k])


def test_bf16_snapshot_forward_matches_jax():
    """A learner snapshot cast to bf16 and loaded back runs the reference's
    forward on the same bf16 weights within the self-play slice's bounds:
    policy logits atol 0.15, scalar values atol 0.1."""
    from keisei_tpu.training.value_adapter import MultiHeadValueAdapter as JaxAdapter
    from keisei_tpu_torch.training.value_adapter import get_value_adapter

    jmodel, _ = jax_build_model("se_resnet", TINY)
    variables = jax.device_get(jax.jit(
        lambda k: jmodel.init(k, jnp.zeros((2, 50, 9, 9)), train=False))(jax.random.key(3)))
    v16 = jax.tree.map(lambda x: x.astype(jnp.bfloat16), variables)
    obs = (np.random.default_rng(0).random((6, 50, 9, 9)) < 0.2).astype(np.float32)
    jout = jmodel.apply(v16, jnp.asarray(obs), train=False)

    sd = {k: v.to(torch.bfloat16) for k, v in
          flax_to_torch(variables["params"], variables["batch_stats"]).items()}
    module, _ = ModelCache().model_for(type("E", (), {"architecture": "se_resnet",
                                                      "model_params": TINY})())
    with torch.no_grad():
        tout = torch.func.functional_call(module, sd, (torch.from_numpy(obs),), strict=True)
    np.testing.assert_allclose(tout.policy_logits.numpy(), np.asarray(jout.policy_logits),
                               atol=0.15)
    np.testing.assert_allclose(get_value_adapter("katago").scalar_value(tout).numpy(),
                               np.asarray(JaxAdapter().scalar_value(jout)), atol=0.1)


def test_matches_and_the_gauntlet(store):
    """Frozen matches: every game counted once, results seeded; the
    historical library's refresh and the gauntlet through the port's
    store, read back through the JAX package."""
    entries = [_add(store, _state_dict(i), epoch=i) for i in range(3)]
    cache = ModelCache()
    (ma, ka), (mb, kb) = cache.model_for(entries[0]), cache.model_for(entries[1])
    assert ma is mb and ka == kb and ma.training is False
    va = store.load_variables_cached(entries[0], dtype="bfloat16")
    vb = store.load_variables_cached(entries[1], dtype="bfloat16")
    res = play_match(ma, va, mb, vb, num_games=4, max_ply=6, chunk_steps=4, seed=3)
    assert res.games == 4 and res.wins_a + res.wins_b + res.draws == 4
    assert res.total_plies == 4 * 6  # every game truncates at max_ply
    runner = make_match_runner(ma, mb, num_games=4, max_ply=6, chunk_steps=4)
    again, rollout = runner(va, vb, seed=3, collect=True)
    assert again == res
    assert rollout.actions.shape[1] == 4 and rollout.obs.shape[2:] == (50, 81)
    assert rollout.dones.any(dim=0).all()

    HistoricalLibrary(store, HistoricalLibraryConfig(slots=3, min_epoch_for_selection=0,
                                                     refresh_interval_epochs=1)).refresh(4)
    gauntlet = HistoricalGauntlet(store, GauntletConfig(interval_epochs=1, games_per_matchup=2),
                                  max_ply=6)
    assert gauntlet.run_gauntlet(4, entries[2]) >= 2
    rows = jax_db.read_league_data(store.db_path)["gauntlet_results"]
    assert rows and all(r["entry_id"] == entries[2].id and r["epoch"] == 4 for r in rows)
    assert all(r["wins"] + r["losses"] + r["draws"] == 2 for r in rows)
    assert len(jax_db.read_historical_slots(store.db_path)) == 3

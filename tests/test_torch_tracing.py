"""The in-program tracer (keisei_tpu_torch/utils/tracing.py) on the CPU:
off it records nothing and hands out one shared no-op; on (under
torch.profiler, or after enable()) it nests spans, links parents, computes
self times, starts each stretch empty and keeps monotonic durations; the
self-play rollout, the PPO update and the trainer's epoch record the spans
and counters the benchmark reads; and nothing the program computes changes
with the tracer on."""

import collections
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from keisei_tpu_torch.env.vec_env import EnvCore
from keisei_tpu_torch.models.registry import build_model, get_model_contract
from keisei_tpu_torch.models.se_resnet import FlaxBatchNorm
from keisei_tpu_torch.training.config import config_from_dict
from keisei_tpu_torch.training.league_rollout import (compact_supported, make_league_rollout,
                                                      parity_colors)
from keisei_tpu_torch.training.loop import SelfPlayTrainer
from keisei_tpu_torch.training.ppo import KataGoPPOParams, make_optimizer, make_ppo_update
from keisei_tpu_torch.training.rollout import make_selfplay_rollout
from keisei_tpu_torch.training.value_adapter import get_value_adapter
from keisei_tpu_torch.utils import tracing

torch.set_num_threads(2)

TINY = {"num_blocks": 1, "channels": 16, "global_pool_channels": 8, "se_reduction": 4,
        "policy_channels": 4, "value_fc_size": 8, "score_fc_size": 4}
N, T, MAX_PLY = 4, 6, 3  # max_ply 3: every env is cut at t = 2 and t = 5
PLY_CHILDREN = {"forward", "sample", "engine.step", "truncation.check", "store"}


@pytest.fixture
def tracer():
    """The program's tracer, on for the test and off after it."""
    tracing.enable()
    try:
        yield tracing.TRACER
    finally:
        tracing.disable()


def by_name(spans, name):
    return [s for s in spans if s["name"] == name]


def children(spans, parent):
    return [s for s in spans if s["parent"] == parent["id"]]


def tiny_model(seed=0):
    torch.manual_seed(seed)
    model, _ = build_model("se_resnet", TINY)
    return model


def adapter():
    return get_value_adapter(get_model_contract("se_resnet"))


def run_rollout(seed=0):
    env = EnvCore(N, MAX_PLY, 50, "cpu")
    rollout = make_selfplay_rollout(env, tiny_model(seed), adapter(), T)
    g = torch.Generator().manual_seed(seed)
    return rollout(*env.init(), g)


def test_off_hands_out_the_shared_no_op_and_records_nothing():
    tracing.disable()
    t = tracing.Tracer()
    assert t.span("x") is tracing.NO_SPAN and t.span("y", index=3) is tracing.NO_SPAN
    with t.span("x"):
        t.count("c")
    assert t.spans() == [] and t.counters() == {}
    tracing.Phases(t).next("a")
    assert t.spans() == []


@pytest.mark.parametrize("how", ["profiler", "enable"])
def test_on_nests_links_parents_and_computes_self_times(how):
    t = tracing.Tracer()

    def record():
        with t.span("outer", epoch=7):
            time.sleep(0.002)
            for i in range(2):
                with t.span("inner", index=i):
                    time.sleep(0.003)
                    t.count("inner", kind="k")
            with t.span("outer"):  # a span of the same name nests like any other
                pass

    if how == "profiler":
        with profile(activities=[ProfilerActivity.CPU]):
            record()
    else:
        t.enable()
        record()
        t.disable()
    spans = t.spans()
    assert [s["name"] for s in spans] == ["inner", "inner", "outer", "outer"]
    outer = spans[3]
    assert outer["parent"] is None and outer["epoch"] == 7
    kids = children(spans, outer)
    assert [(k["name"], k["index"]) for k in kids] == [("inner", 0), ("inner", 1),
                                                       ("outer", None)]
    assert all(k["epoch"] == 7 and k["thread"] == outer["thread"] for k in kids)
    for k in kids:
        assert outer["start_ns"] <= k["start_ns"] <= k["end_ns"] <= outer["end_ns"]
        assert k["self_ns"] == k["end_ns"] - k["start_ns"]
    covered = sum(k["end_ns"] - k["start_ns"] for k in kids)
    assert outer["self_ns"] == outer["end_ns"] - outer["start_ns"] - covered
    assert outer["self_ns"] >= 2_000_000
    assert t.counters() == {"inner": 2, "inner.k": 2}


def test_durations_hold_when_the_wall_clock_steps(monkeypatch):
    """Spans run on the monotonic clock, put on the wall clock's nanoseconds
    by one offset a stretch: a step of the wall clock moves no duration."""
    t = tracing.Tracer()
    t.enable()
    before = time.time_ns()
    with t.span("a"):
        monkeypatch.setattr(tracing.time, "time_ns", lambda: before - 3600 * 10**9)
        time.sleep(0.002)
        with t.span("b"):
            pass
    b, a = t.spans()
    assert 2_000_000 <= a["end_ns"] - a["start_ns"] < 10**9
    assert a["start_ns"] <= b["start_ns"] <= b["end_ns"] <= a["end_ns"]
    assert abs(a["start_ns"] - before) < 10**9


def test_a_new_stretch_clears_the_buffer(tmp_path):
    t = tracing.Tracer()
    t.enable()
    with t.span("first"):
        t.count("n")
    t.disable()
    with t.span("between"):  # off: seen, not recorded
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        with t.span("second", sync=2):
            pass
    assert [s["name"] for s in t.spans()] == ["second"]
    assert t.counters() == {"host_syncs": 2, "host_syncs.second": 2}
    t.dump(str(tmp_path / "trace.jsonl"))
    lines = (tmp_path / "trace.jsonl").read_text().splitlines()
    assert len(lines) == 2 and '"second"' in lines[0] and '"counters"' in lines[1]


def test_phases_share_their_stamps():
    t = tracing.Tracer()
    t.enable()
    ph = tracing.Phases(t)
    stamps = [ph.next("a"), ph.next("b"), ph.next()]
    a, b = t.spans()
    assert (a["name"], b["name"]) == ("a", "b") and a["end_ns"] == b["start_ns"]
    assert a["end_ns"] - a["start_ns"] == stamps[1] - stamps[0]
    assert b["end_ns"] - b["start_ns"] == stamps[2] - stamps[1]
    assert abs(a["start_ns"] - time.time_ns()) < 10**9  # on the wall clock's nanoseconds


# the three rollout loops: (envs, cohort size K; None: self-play)
LOOPS = {"selfplay": (N, None), "compact": (4, 2), "dynamic": (6, 3)}


def run_loop(loop, seed=0):
    """(envs, opponent blocks a ply, host reads of the stats, RolloutStats)."""
    n, K = LOOPS[loop]
    if K is None:
        return n, 0, 1, run_rollout(seed)[3]
    env = EnvCore(n, MAX_PLY, 50, "cpu")
    opps = [tiny_model(seed + 1 + k).state_dict() for k in range(K)]
    stacked = {name: torch.stack([sd[name] for sd in opps]) for name in opps[0]}
    rollout = make_league_rollout(env, tiny_model(seed), adapter(), T, K)
    compact = compact_supported(T, K)
    assert compact == (loop == "compact")
    colors = parity_colors(n) if compact else torch.arange(n) % 2
    stats = rollout(stacked, *env.init(), colors, torch.Generator().manual_seed(seed))[3]
    return n, K // 2 if compact else K, 2 if compact else 1, stats.base


@pytest.mark.parametrize("loop", list(LOOPS))
def test_rollout_records_each_ply_and_its_counters(tracer, loop):
    """Each loop's plies come from the shared ply pieces: the same span tree
    and counters, the league's plies adding its opponents' forwards."""
    n, opp_blocks, stats_syncs, stats = run_loop(loop)
    spans = tracer.spans()
    (rollout,) = by_name(spans, "rollout")
    plies = by_name(spans, "ply")
    assert [p["index"] for p in plies] == list(range(T))
    assert all(p["parent"] == rollout["id"] for p in plies)
    cut = []
    for p in plies:
        names = collections.Counter(c["name"] for c in children(spans, p))
        if names.pop("truncation.forward", 0) == 1:
            cut.append(p["index"])
        # one sample per forward, the learner's and each opponent block's
        assert names == collections.Counter(
            {**dict.fromkeys(PLY_CHILDREN, 1), "sample": 1 + opp_blocks,
             "forward.opponent": opp_blocks}), names
    assert cut == [MAX_PLY - 1, 2 * MAX_PLY - 1] and stats.truncated == 2 * n
    assert {c["name"] for c in children(spans, rollout)} == {"ply", "forward.last",
                                                             "rollout.stats"}
    assert [s["sync"] for s in by_name(spans, "truncation.check")] == [1] * T
    assert [s["sync"] for s in by_name(spans, "rollout.stats")] == [stats_syncs]
    c = tracer.counters()
    assert c["plies"] == T and c["host_syncs"] == T + stats_syncs
    assert c["host_syncs.truncation.check"] == T
    assert c["host_syncs.rollout.stats"] == stats_syncs
    assert (len(by_name(spans, "forward")), len(by_name(spans, "truncation.forward")),
            len(by_name(spans, "forward.last")), len(by_name(spans, "forward.opponent"))) \
        == (T, len(cut), 1, T * opp_blocks)
    assert all("device_ms" not in s for s in spans)  # CUDA events: on a card alone


def test_ppo_update_records_each_minibatch(tracer):
    traj, next_value = run_rollout()[1:3]
    tracing.disable()
    tracing.enable()  # a new stretch: the update's spans alone
    model = tiny_model()
    cfg = KataGoPPOParams(batch_size=8, epochs_per_batch=3)
    update = make_ppo_update(model, adapter(), cfg, make_optimizer(model, cfg))
    update(traj, next_value, torch.Generator().manual_seed(1), 0.01)
    spans = tracer.spans()
    n_mb = N * T // cfg.batch_size
    mbs = by_name(spans, "minibatch")
    assert [m["index"] for m in mbs] == list(range(cfg.epochs_per_batch * n_mb))
    for m in mbs:
        assert [c["name"] for c in children(spans, m)] == ["backward", "clip", "optimizer"]
    assert [s["name"] for s in spans if s["parent"] is None] == \
        ["update.prepare"] + ["minibatch"] * len(mbs) + ["update.means"]
    # one host sync; each train-mode BatchNorm call counted by its path (the
    # CPU's written-out code)
    bns = sum(isinstance(m, FlaxBatchNorm) for m in model.modules()) * len(mbs)
    assert tracer.counters() == {"host_syncs": 1, "host_syncs.update.means": 1,
                                 "bn.train": bns, "bn.train.plain": bns}


def trainer_config(tmp_path, seed=0):
    return config_from_dict({
        "model": {"architecture": "se_resnet", "params": TINY},
        "training": {"num_games": N, "max_ply": MAX_PLY, "steps_per_epoch": T, "seed": seed,
                     "checkpoint_interval": 100, "checkpoint_dir": str(tmp_path / "ck"),
                     "algorithm_params": {"batch_size": 8, "epochs_per_batch": 2}},
        "display": {"db_path": str(tmp_path / "obs.db")},
    })


def test_run_epoch_spans_hold_the_epoch_metrics_times(tmp_path, tracer):
    trainer = SelfPlayTrainer(trainer_config(tmp_path), device="cpu")
    em = trainer.run_epoch()
    spans = tracer.spans()
    (epoch,) = by_name(spans, "epoch")
    assert epoch["epoch"] == em.epoch == 1
    parts = children(spans, epoch)
    assert [p["name"] for p in parts] == ["phase.rollout", "phase.update", "phase.upkeep",
                                          "phase.observe"]
    rollout, update, upkeep, observe = parts
    assert rollout["end_ns"] == update["start_ns"] and update["end_ns"] == upkeep["start_ns"]
    assert upkeep["end_ns"] == observe["start_ns"]
    for span, seconds in ((rollout, em.rollout_time), (update, em.update_time),
                          (upkeep, em.maint_time)):
        assert (span["end_ns"] - span["start_ns"]) / 1e9 == seconds
    assert all(s["epoch"] == 1 for s in spans)
    (call,) = by_name(spans, "rollout")
    assert call["parent"] == rollout["id"]
    assert [p["parent"] for p in by_name(spans, "ply")] == [call["id"]] * T
    assert {m["parent"] for m in by_name(spans, "minibatch")} == {update["id"]}
    assert {c["name"] for c in children(spans, observe)} == {"snapshot.read"}
    assert tracer.counters()["host_syncs.snapshot.read"] == 6
    trainer.close()


def test_tracing_changes_nothing_the_program_computes(tmp_path):
    tracing.disable()
    off = run_rollout(seed=3)
    tracing.enable()
    try:
        on = run_rollout(seed=3)
    finally:
        tracing.disable()
    for name in ("obs", "actions", "log_probs", "values", "rewards", "next_value_override"):
        assert torch.equal(getattr(off[1], name).nan_to_num(), getattr(on[1], name).nan_to_num())
    assert torch.equal(off[2], on[2]) and off[3] == on[3]

    states = []
    for traced in (False, True):
        (tmp_path / str(traced)).mkdir()
        trainer = SelfPlayTrainer(trainer_config(tmp_path / str(traced), seed=5), device="cpu")
        if traced:
            tracing.enable()
        try:
            trainer.run_epoch()
        finally:
            tracing.disable()
        states.append(trainer.model.state_dict())
        trainer.close()
    for k, v in states[0].items():
        assert torch.equal(v, states[1][k]), k

"""Data parallelism of the port (keisei_tpu_torch/parallel/) on the CPU:
two ranks over gloo, spawned once for the module (tests/_torch_parallel_ranks.py).

The JAX package's mesh makes the BatchNorm statistics, the advantage
normalisation, the permutation, the clip norm and the counts global: W
ranks must together compute what one process computes on the whole batch.
The one-process update is held to op-by-op JAX by test_torch_training.py;
here W=2, each rank on its half of the envs, is held to W=1 on the whole
with the same permutations, within 1e-6 in f32 (losses, grad norm,
parameters, BatchNorm statistics, Adam moments): only the order of sums
differs. Then whole trainers at W=2 (self-play and league), which must end
bit-identical on both ranks with rank 1 having written nothing, and
checkpoints across W=2 <-> W=1, which must restore exactly. The launch
environment's parsing is held to the JAX package's.
"""

import dataclasses
import os
import subprocess
import sys
import tomllib
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

import _torch_parallel_ranks as R
from keisei_tpu.parallel import distributed as JD
from keisei_tpu_torch.parallel import distributed as D
from keisei_tpu_torch.parallel.mesh import Mesh, make_mesh, shard_env_batch
from keisei_tpu_torch.parallel.placement import learner_device
from keisei_tpu_torch.training.config import load_config
from keisei_tpu_torch.training.loop import SelfPlayTrainer

REPO = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-6, atol=1e-6)


# -- the launch environment -----------------------------------------------------------

ENVS = {
    "none": {},
    "auto": {"KEISEI_DISTRIBUTED": "AUTO"},
    "two": {"KEISEI_COORDINATOR": "h:1", "KEISEI_NUM_PROCESSES": "2", "KEISEI_PROCESS_ID": "1"},
    "default_pid": {"KEISEI_COORDINATOR": "h:1", "KEISEI_NUM_PROCESSES": "4"},
    "one_process": {"KEISEI_COORDINATOR": "h:1", "KEISEI_NUM_PROCESSES": "1"},
    "no_count": {"KEISEI_COORDINATOR": "h:1"},
    "pid_out_of_range": {"KEISEI_COORDINATOR": "h:1", "KEISEI_NUM_PROCESSES": "2",
                         "KEISEI_PROCESS_ID": "2"},
    "negative_pid": {"KEISEI_COORDINATOR": "h:1", "KEISEI_NUM_PROCESSES": "2",
                     "KEISEI_PROCESS_ID": "-1"},
    "bad_int": {"KEISEI_COORDINATOR": "h:1", "KEISEI_NUM_PROCESSES": "two"},
    "count_without_coordinator": {"KEISEI_NUM_PROCESSES": "2", "KEISEI_PROCESS_ID": "1"},
}


@pytest.mark.parametrize("name", list(ENVS))
def test_context_parsing_matches_jax(name):
    """The same env dicts through both parsers: equal fields, or the same
    error type and message."""
    env = ENVS[name]
    try:
        want = JD.get_distributed_context(env)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            D.get_distributed_context(env)
        assert str(got.value) == str(e)
        return
    got = D.get_distributed_context(env)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.is_main, got.is_distributed) == (want.is_main, want.is_distributed)


def test_process_seed_matches_jax():
    for pid in range(3):
        ctx = JD.DistributedContext(process_id=pid, num_processes=3, coordinator="h:1")
        ours = D.DistributedContext(process_id=pid, num_processes=3, coordinator="h:1")
        assert D.process_seed(42, ours) == JD.process_seed(42, ctx) == D.process_seed(42, pid)


@pytest.mark.parametrize("num_devices,hosts,want", [
    (0, 1, (1, 1)), (1, 1, (1, 1)), (-1, 1, (1, 1)), (-1, 2, (2, 1)), (2, 1, (2, 2)),
    (4, 2, (4, 2)), (0, 2, ValueError), (3, 2, ValueError), (-2, 1, ValueError)])
def test_rank_layout_on_the_cpu(num_devices, hosts, want):
    """num_devices 0/1: one rank; -1: every visible device (on the CPU one
    rank per host process); N: N ranks split over the hosts. A launch of
    several processes for one rank, or an uneven split, raises."""
    ctx = D.DistributedContext(num_processes=hosts, coordinator="h:1" if hosts > 1 else None)
    if want is ValueError:
        with pytest.raises(ValueError):
            D.rank_layout(num_devices, ctx, "cpu")
    else:
        assert D.rank_layout(num_devices, ctx, "cpu") == want


TORCHRUN = {"RANK": "3", "WORLD_SIZE": "4", "LOCAL_RANK": "1", "LOCAL_WORLD_SIZE": "2",
            "MASTER_ADDR": "h", "MASTER_PORT": "29500"}


@pytest.mark.parametrize("change,want", [
    ({}, ("h:29500", 4, 2, 2, 1)),
    ({"LOCAL_RANK": None, "LOCAL_WORLD_SIZE": None}, ("h:29500", 4, 4, 3, 0)),
    ({"MASTER_ADDR": None}, "MASTER_ADDR not set"),
    ({"MASTER_PORT": None, "RANK": None}, "RANK, MASTER_PORT not set"),
    ({"WORLD_SIZE": "four"}, "bad launcher env vars"),
    ({"RANK": "4"}, "RANK 4 out of range"),
    ({"LOCAL_RANK": "2"}, "do not fit"),
])
def test_torchrun_layout(change, want):
    """KEISEI_DISTRIBUTED=auto: the ranks from torchrun's variables, and a
    missing or inconsistent one named in a ValueError."""
    env = {k: v for k, v in {**TORCHRUN, **change}.items() if v is not None}
    if isinstance(want, str):
        with pytest.raises(ValueError, match=want):
            D.torchrun_layout(env)
    else:
        assert D.torchrun_layout(env) == want


def test_failed_group_start_raises():
    """No fallback: a bad coordinator, NCCL on the CPU, or a group whose
    other rank never comes all raise; the trainer never runs alone."""
    with pytest.raises(ValueError, match="host:port"):
        D.setup_distributed("nohost", world_size=2, rank=0, device="cpu")
    with pytest.raises(ValueError, match="needs a card"):
        D.setup_distributed("localhost:1", world_size=1, rank=0, device="cpu", backend="nccl")
    from datetime import timedelta
    with pytest.raises(dist.DistStoreError):  # the store's wait for rank 1 times out
        D.setup_distributed(f"localhost:{D.free_port()}", world_size=2, rank=0,
                            device="cpu", timeout=timedelta(seconds=1))
    assert not dist.is_initialized()


def test_nccl_refuses_two_ranks_on_one_card():
    """Before the group starts, each NCCL rank publishes its card on the
    rendezvous store; a second rank on the same card raises."""
    store = dist.HashStore()
    store.set("keisei/device/0", "host/GPU-0")
    D.check_distinct_devices(store, 1, 2, "host/GPU-1")  # distinct: fine
    store.set("keisei/device/1", "")
    with pytest.raises(RuntimeError, match="NCCL needs one card per rank"):
        D.check_distinct_devices(store, 1, 2, "host/GPU-0")


def test_mesh_layout_and_refusals():
    """Rank r holds global envs [r N/W, (r+1) N/W); without a group a mesh
    of several devices is refused, one device is a mesh with no group."""
    x = torch.arange(12)
    assert shard_env_batch(Mesh(world_size=3, rank=1), {"x": x})["x"].tolist() == [4, 5, 6, 7]
    with pytest.raises(ValueError, match="divide evenly"):
        Mesh(world_size=5).env_slice(12)
    with pytest.raises(ValueError, match="none is running"):
        make_mesh(2, device="cpu")
    single = make_mesh(-1, device="cpu")
    assert single.group is None and single.world_size == 1
    tree = {"keys": torch.ones(2)}
    assert D.broadcast_from_main(tree, single) is tree  # one rank: unchanged
    assert learner_device("cpu", 3) == torch.device("cpu")


@pytest.mark.parametrize("mode", ["fused", "int8"])
def test_trainer_refuses_rank_only_paths(tmp_path, mode):
    """The fused and int8 rollout forwards need one rank, as the JAX
    package refuses its Pallas forwards under a mesh; num_devices that the
    mesh does not have raises; so does a trainer asked for ranks with none."""
    two = Mesh(world_size=2, group=object())  # refused before any collective
    cfg = R.tiny_config(str(tmp_path), num_games=32, rollout_forward=mode)
    with pytest.raises(ValueError, match="needs a single rank"):
        SelfPlayTrainer(cfg, device="cpu", mesh=two)
    with pytest.raises(ValueError, match="the mesh has 2 ranks"):
        SelfPlayTrainer(R.tiny_config(str(tmp_path), num_devices=4), device="cpu", mesh=two)
    with pytest.raises(ValueError, match="would train alone"):
        SelfPlayTrainer(R.tiny_config(str(tmp_path), num_devices=2), device="cpu")


def test_multihost_config_loads():
    """configs/katago-league-multihost.toml (num_devices = -1, league,
    sidecar tournament) loads in the port, as in the JAX package."""
    from keisei_tpu.training.config import load_config as jax_load_config

    path = str(REPO / "configs" / "katago-league-multihost.toml")
    ours, theirs = load_config(path), jax_load_config(path)
    assert ours.distributed.num_devices == -1 and ours.league.enabled
    for section in ("model", "training", "algorithm_params", "distributed"):
        assert vars(getattr(ours, section)) == vars(getattr(theirs, section)), section


# -- two ranks, spawned once ------------------------------------------------------------

UPDATES = {
    # name: (trajectory seed, league, PPO params)
    "selfplay": (3, False, dict(batch_size=16, epochs_per_batch=2)),
    "selfplay_uneven_slices": (4, False, dict(batch_size=15, epochs_per_batch=1)),
    "league_weighted": (6, True, dict(batch_size=16, epochs_per_batch=2)),
}


def _update_cases() -> dict:
    """Each case starts from the tiny model one update in, with its Adam
    state: Adam's first step divides each gradient by its own magnitude
    (m/sqrt(v) = g/|g|, eps 1e-8), so a gradient within a few eps of zero
    turns a rounding difference of 1e-9 (f32 sums in another order) into
    a percent of lr; one step in, v carries the earlier gradients and the
    step is well conditioned."""
    torch.manual_seed(0)
    model = R.tiny_model()
    cfg = R.P.KataGoPPOParams(batch_size=16, epochs_per_batch=1)
    opt = R.P.make_optimizer(model, cfg)
    traj, nv = R.trajectory(100)
    R.P.make_ppo_update(model, R.get_value_adapter("katago", **R.ADAPTER), cfg, opt)(
        R.P.Trajectory(**{k: torch.from_numpy(v) for k, v in traj.items()}),
        torch.from_numpy(nv), torch.Generator().manual_seed(100), 0.01)
    state, optimizer = model.state_dict(), opt.state_dict()
    cases = {}
    for name, (seed, league, cfg) in UPDATES.items():
        traj, nv = R.trajectory(seed, league=league)
        S = traj["rewards"].size
        g = torch.Generator().manual_seed(seed)
        perms = [torch.randperm(S, generator=g) for _ in range(cfg["epochs_per_batch"])]
        cases[name] = {"state": state, "optimizer": optimizer, "traj": traj, "nv": nv,
                       "perms": perms,
                       "cfg": dict(cfg, learning_rate=2e-4, lambda_score=0.1,
                                   score_blend_alpha=0.1)}
    return cases


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The W=1 references, then one spawn of two ranks that runs every
    scenario (R.session)."""
    torch.set_num_threads(2)
    root = tmp_path_factory.mktemp("parallel")
    cases = _update_cases()
    # a W=1 checkpoint for the ranks to resume: one epoch, then a save
    w1_root = str(root / "w1")
    w1 = SelfPlayTrainer(R.tiny_config(w1_root, num_devices=0, checkpoint_interval=100),
                         device="cpu")
    w1.run_epoch()
    w1.save()
    w1_state = R.state_of(w1.model, w1.optimizer)
    w1.close()
    out = R.run_ranks(R.session, 2, {"updates": cases, "root": str(root), "w1_root": w1_root},
                      str(root))
    return {"cases": cases, "root": root, "w1": (w1_state, w1.generator.get_state()),
            "out": out}


def _assert_states(a: dict, b: dict, exact: bool, **tol):
    assert a["model"].keys() == b["model"].keys() and a["adam"].keys() == b["adam"].keys()
    for k in a["model"]:
        if exact:
            assert torch.equal(a["model"][k], b["model"][k]), k
        else:
            np.testing.assert_allclose(a["model"][k].numpy(), b["model"][k].numpy(),
                                       err_msg=k, **tol)
    for k in a["adam"]:
        for m in ("exp_avg", "exp_avg_sq", "step"):
            if exact:
                assert torch.equal(a["adam"][k][m], b["adam"][k][m]), (k, m)
            else:
                np.testing.assert_allclose(a["adam"][k][m].numpy(), b["adam"][k][m].numpy(),
                                           err_msg=f"{k}.{m}", **tol)


@pytest.mark.parametrize("name", list(UPDATES))
def test_update_over_two_ranks_equals_one(ranks, name):
    """Each rank updates on its half of the envs; both must match W=1 on
    the whole trajectory (the same permutations) within 1e-6 and equal
    each other bit for bit. `selfplay_uneven_slices` has minibatches of 15
    rows (ranks take 7 and 8); `league_weighted` a sparse `valid`."""
    want_metrics, want_state = R.run_update(ranks["cases"][name])
    (m0, s0), (m1, s1) = (r["updates"][name] for r in ranks["out"])
    assert m0 == m1
    _assert_states(s0, s1, exact=True)
    for k, v in want_metrics.items():
        np.testing.assert_allclose(m0[k], v, err_msg=k, **TOL)
    _assert_states(s0, want_state, exact=False, **TOL)


@pytest.mark.parametrize("mode", ["selfplay", "league"])
def test_trainer_ranks_end_bit_identical(ranks, mode):
    """Two epochs at W=2: parameters, BatchNorm statistics, Adam moments,
    the losses and the permutation generator are the same bits on both
    ranks; each epoch's counts are global, the sum of the ranks' own, and
    the league's parity invariant holds. Parameters moved."""
    r0, r1 = (r[mode] for r in ranks["out"])
    _assert_states(r0["state"], r1["state"], exact=True)
    assert torch.equal(r0["generator"], r1["generator"])
    assert len(r0["epochs"]) == len(r1["epochs"]) == 2
    for (m0, local0), (m1, local1) in zip(r0["epochs"], r1["epochs"]):
        for k in ("policy_loss", "value_loss", "score_loss", "entropy", "gradient_norm",
                  "episodes", "wins_black", "wins_white", "draws", "truncated"):
            assert m0[k] == m1[k], k
            assert np.isfinite(m0[k]), k
        base0 = local0["base"] if mode == "league" else local0
        base1 = local1["base"] if mode == "league" else local1
        for k in ("episodes", "wins_black", "wins_white", "draws", "truncated"):
            assert m0[k] == base0[k] + base1[k], k
        if mode == "league":
            assert local0["parity_mismatch"] == local1["parity_mismatch"] == 0
    torch.manual_seed(0)
    start = R.tiny_model().state_dict()
    assert any(not torch.equal(start[k], v) for k, v in r0["state"]["model"].items())


@pytest.mark.parametrize("mode", ["selfplay", "league"])
def test_rank1_writes_nothing(ranks, mode):
    """Rank 1 opened no file for writing, saved no tensor, made no
    directory and connected to no database, and holds no league store;
    rank 0 wrote the DB, the checkpoints (and the league's files)."""
    r0, r1 = (r[mode] for r in ranks["out"])
    assert r1["writes"] == []
    root = ranks["root"] / ("sp" if mode == "selfplay" else "lg")
    assert (root / "obs.db").is_file()
    assert sorted(os.listdir(root / "ck")) == ["epoch_000001", "epoch_000002"]
    if mode == "league":
        assert r0["store"] is True and r1["store"] is False
        assert os.listdir(root / "league")


def test_cohort_broadcast_bit_for_bit(ranks):
    """Rank 1 plays rank 0's cohort: the K-stacked bf16 state dict it
    received equals rank 0's, bit for bit."""
    c0, c1 = (r["league"]["cohort"] for r in ranks["out"])
    assert c0.keys() == c1.keys()
    for k in c0:
        assert c0[k].dtype == torch.bfloat16 or not c0[k].is_floating_point()
        assert torch.equal(c0[k], c1[k]), k


def test_swapped_cohort_block_resets_in_global_indices(ranks):
    """Rank 0 samples a cohort that swaps the entry of slot K-1 (K=2:
    global envs [4, 8), all of rank 1's); rank 1 learns it from the
    broadcast keys and restarts exactly those envs with the parity colors
    of a fresh game; rank 0's envs play on."""
    s0, s1 = (r["league"]["swap"] for r in ranks["out"])
    assert s0["keys"] == s1["keys"] and s0["keys"][0] != s0["keys"][1]
    assert s0["reset"] == [False] * 4 and s1["reset"] == [True] * 4
    assert s1["color"].tolist() == [1] * 4  # global envs 4..7: the White half


def test_checkpoint_two_ranks_to_one(ranks, tmp_path):
    """The W=2 self-play run's last checkpoint resumes in a W=1 trainer
    with rank 0's parameters, BatchNorm statistics, Adam state and
    permutation generator, exactly."""
    sp = ranks["out"][0]["selfplay"]
    cfg = R.tiny_config(str(ranks["root"] / "sp"), num_devices=0)
    cfg = dataclasses.replace(cfg, display=dataclasses.replace(cfg.display, db_path=""))
    w1 = SelfPlayTrainer(cfg, device="cpu")
    assert w1.epoch == 2
    _assert_states(R.state_of(w1.model, w1.optimizer), sp["state"], exact=True)
    assert torch.equal(w1.generator.get_state(), sp["generator"])
    w1.close()


def test_checkpoint_one_rank_to_two(ranks):
    """A W=1 checkpoint resumes on both ranks exactly; the permutation
    generator is restored on every rank, and rank r's rollout generator is
    seeded with process_seed(seed + epoch * W, r) (training/checkpoint.py)."""
    w1_state, w1_gen = ranks["w1"]
    for rank, r in enumerate(ranks["out"]):
        res = r["resumed"]
        assert res["epoch"] == 1
        _assert_states(res["state"], w1_state, exact=True)
        assert torch.equal(res["generator"], w1_gen)
        want = torch.Generator().manual_seed(D.process_seed(42 + 1 * 2, rank)).get_state()
        assert torch.equal(res["rollout_generator"], want)


# -- the entry points -----------------------------------------------------------------


def _multihost_cut(tmp_path: Path, num_devices: int) -> str:
    """configs/katago-league-multihost.toml cut in width (2 blocks x 16
    channels) and scale (8 games, 4 plies, batch 8), its paths in tmp_path."""
    with open(REPO / "configs" / "katago-league-multihost.toml", "rb") as f:
        raw = tomllib.load(f)
    raw["model"]["params"].update(num_blocks=2, channels=16, global_pool_channels=8,
                                  se_reduction=4, policy_channels=4, value_fc_size=16,
                                  score_fc_size=8)
    raw["training"].update(num_games=8, max_ply=16, steps_per_epoch=4,
                           checkpoint_dir=str(tmp_path / "ck"))
    raw["training"]["algorithm_params"].update(batch_size=8, epochs_per_batch=1)
    raw["display"]["db_path"] = str(tmp_path / "obs.db")
    raw["distributed"]["num_devices"] = num_devices
    raw["league"]["storage"]["league_dir"] = str(tmp_path / "league")
    raw["league"]["concurrency"].update(parallel_matches=1, envs_per_match=2)
    lines = []

    def emit(prefix, table):
        scalars = {k: v for k, v in table.items() if not isinstance(v, dict)}
        if prefix:
            lines.append(f"[{prefix}]")
        for k, v in scalars.items():
            lines.append(f"{k} = {_toml(v)}")
        for k, v in table.items():
            if isinstance(v, dict):
                emit(f"{prefix}.{k}" if prefix else k, v)
    emit("", raw)
    path = tmp_path / "multihost-cut.toml"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _toml(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, str):
        return '"' + v.replace("\\", "\\\\") + '"'
    if isinstance(v, list):
        return "[" + ", ".join(_toml(x) for x in v) + "]"
    return repr(v)


@pytest.mark.parametrize("launch", ["keisei_env_two_processes", "one_process_spawns_ranks",
                                    "torchrun_env_two_processes"])
def test_main_trains_over_two_ranks(tmp_path, launch):
    """`python -m keisei_tpu_torch.training.loop` on a cut copy of
    configs/katago-league-multihost.toml, two league epochs at two CPU
    ranks: two OS processes joined by KEISEI_COORDINATOR / NUM_PROCESSES /
    PROCESS_ID (num_devices = -1: one rank per process on the CPU); one
    process with num_devices = 2 that spawns both ranks; or two OS
    processes under KEISEI_DISTRIBUTED=auto with the variables torchrun
    sets (RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE, MASTER_ADDR,
    MASTER_PORT), as two ranks of one host. Both ranks log equal losses;
    rank 0 alone writes the checkpoint, the DB and the league."""
    cfg = _multihost_cut(tmp_path, num_devices=-1 if launch.startswith("keisei") else 2)
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    per_process = [{}]
    if launch.startswith("keisei"):
        env.update(KEISEI_COORDINATOR=f"localhost:{D.free_port()}", KEISEI_NUM_PROCESSES="2")
        per_process = [{"KEISEI_PROCESS_ID": pid} for pid in ("0", "1")]
    elif launch.startswith("torchrun"):
        env.update(KEISEI_DISTRIBUTED="auto", WORLD_SIZE="2", LOCAL_WORLD_SIZE="2",
                   MASTER_ADDR="localhost", MASTER_PORT=str(D.free_port()))
        per_process = [{"RANK": r, "LOCAL_RANK": r} for r in ("0", "1")]
    procs = [subprocess.Popen([sys.executable, "-m", "keisei_tpu_torch.training.loop",
                               "--config", cfg, "--device", "cpu", "--epochs", "2"],
                              env={**env, **extra}, cwd=tmp_path, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for extra in per_process]
    logs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        logs.append(out)
        assert p.returncode == 0, out[-3000:]
    lines = [line for log in logs for line in log.splitlines() if " INFO epoch " in line]
    epochs = sorted(line.split("INFO ", 1)[1].split(" rollout=")[0] for line in lines)
    assert len(epochs) == 4 and epochs[0::2] == epochs[1::2], epochs
    assert os.listdir(tmp_path / "ck") == ["epoch_000002"]
    assert (tmp_path / "obs.db").is_file() and os.listdir(tmp_path / "league")


def test_dryrun_multichip_on_the_cpu():
    """scripts/dryrun_multichip.py at two CPU ranks over gloo: the train
    step, the league split-merge, and the checkpoint saved at W=2 and
    restored at W=1, each checked by the script."""
    from keisei_tpu_torch.scripts.dryrun_multichip import dryrun_multichip

    report = dryrun_multichip(2, device="cpu")
    assert report["ranks"] == 2 and all(np.isfinite(v) for v in report["losses"].values())

"""The league rollout over data-parallel ranks against the JAX package's
single-device league rollout, its draws replayed (the harness of
tests/test_torch_league_rollout.py): rank r runs global envs
[r N/W, (r+1) N/W), and the ranks' trajectories, next values and carries,
concatenated in rank order, and their LeagueStats, summed, must equal the
reference's, at the tolerances of that file.

K=4 over W=2 (a rank holds whole opponent blocks) runs two real ranks over
gloo, whose counts are summed by the rollout's all-reduce; K=2 over W=4 (a
block spans two ranks) runs each rank's columns in turn in this process
(the rollout is column-separable) and sums the counts by hand. Both on
the compact (parity-locked) and the dynamic path.
"""

import numpy as np
import pytest
import torch

import _torch_parallel_ranks as R
from keisei_tpu_torch.models.convert import flax_to_torch
from keisei_tpu_torch.training.league_rollout import compact_supported, parity_colors
from test_torch_league_rollout import TINY, _run_jax

torch.set_num_threads(2)

CASES = {
    # name: (N, T, K, max_ply, color_randomization, colors, W)
    "compact_K4_W2": (8, 8, 4, 5, True, "parity", 2),
    "dynamic_K4_W2": (8, 7, 4, 4, True, [0, 1] * 4, 2),
    "compact_K2_W4": (8, 8, 2, 5, True, "parity", 4),
    "dynamic_K2_W4": (8, 7, 2, 4, True, [0, 1] * 4, 4),
}
REAL = [name for name, c in CASES.items() if c[-1] == 2]


def _labelled(draws, N, T, K, cr, compact) -> dict:
    """JAX's draws in call order, keyed (ply, seat, block) with the global
    env columns each covers: per ply the learner (the moving half on the
    compact path, every env on the dynamic one), then the opponent blocks
    in index order, then (dynamic, colors re-rolled) the color draw."""
    B, H, KH = N // K, N // 2, K // 2
    keys = []
    for t in range(T):
        if compact:
            p = t % 2
            keys.append(((t, "learner", None), p * H, (p + 1) * H))
            keys += [((t, "opponent", k), k * B, (k + 1) * B)
                     for k in (range(KH, K) if p == 0 else range(KH))]
        else:
            keys.append(((t, "learner", None), 0, N))
            keys += [((t, "opponent", k), k * B, (k + 1) * B) for k in range(K)]
            if cr:
                keys.append(((t, "color", None), 0, N))
    assert len(keys) == len(draws)
    return {key: (lo, hi, d) for (key, lo, hi), d in zip(keys, draws)}


def _case(monkeypatch, name):
    N, T, K, max_ply, cr, colors, W = CASES[name]
    colors = np.asarray(parity_colors(N) if colors == "parity" else colors, np.int32)
    learner, opps, draws, jcarry, jtraj, jnv, jstats = _run_jax(
        monkeypatch, N, T, K, max_ply, cr, colors)
    monkeypatch.undo()
    sds = [flax_to_torch(o["params"], o["batch_stats"]) for o in opps]
    case = {"N": N, "T": T, "K": K, "max_ply": max_ply, "cr": cr, "colors": colors,
            "model_params": TINY,
            "learner": flax_to_torch(learner["params"], learner["batch_stats"]),
            "stacked": {k: torch.stack([sd[k] for sd in sds]) for k in sds[0]},
            "draws": _labelled(draws, N, T, K, cr, compact_supported(T, K, cr))}
    return case, (jcarry, jtraj, jnv, jstats)


@pytest.fixture(scope="module")
def real_ranks(tmp_path_factory):
    """The JAX references of the W=2 cases, then two spawned ranks that
    replay them."""
    mp = pytest.MonkeyPatch()
    try:
        refs = {name: _case(mp, name) for name in REAL}
    finally:
        mp.undo()
    out = R.run_ranks(R.league_rollouts, 2, {n: c for n, (c, _) in refs.items()},
                      str(tmp_path_factory.mktemp("rollout")))
    return refs, out


def _concat(parts: list[dict]) -> dict:
    traj = {k: torch.cat([p["traj"][k] for p in parts], dim=1) for k in parts[0]["traj"]}
    return {"traj": traj, **{k: torch.cat([p[k] for p in parts]) for k in
                              ("nv", "obs", "masks", "color")}}


def _assert_matches_jax(name, got: dict, stats, ref):
    """The checks of test_torch_league_rollout.py on the concatenated ranks."""
    N, T, K, max_ply, cr, _, _ = CASES[name]
    jcarry, jtraj, jnv, jstats = ref
    traj = got["traj"]
    compact = compact_supported(T, K, cr)
    assert traj["valid"].shape == ((T // 2 + 1) if compact else (T + 1), N)
    for field in ("obs", "actions", "rewards", "dones", "terminated", "legal_masks",
                  "value_cats", "score_targets", "valid"):
        np.testing.assert_array_equal(traj[field].numpy(), np.asarray(getattr(jtraj, field)),
                                      err_msg=field)
    valid = traj["valid"].numpy()
    assert valid.any() and traj["dones"].numpy().any()
    jov, tov = np.asarray(jtraj.next_value_override), traj["next_value_override"].numpy()
    np.testing.assert_array_equal(np.isnan(tov), np.isnan(jov))
    assert (~np.isnan(tov)).any(), "no truncation bootstrap was exercised"
    np.testing.assert_allclose(tov, jov, atol=0.1)
    np.testing.assert_allclose(traj["values"].numpy()[valid], np.asarray(jtraj.values)[valid],
                               atol=0.1)
    np.testing.assert_allclose(traj["log_probs"].numpy()[valid],
                               np.asarray(jtraj.log_probs)[valid], atol=0.3)
    np.testing.assert_allclose(got["nv"].numpy(), np.asarray(jnv), atol=0.1)
    np.testing.assert_array_equal(got["obs"].numpy(), np.asarray(jcarry[1]))
    np.testing.assert_array_equal(got["masks"].numpy(), np.asarray(jcarry[2]))
    np.testing.assert_array_equal(got["color"].numpy(), np.asarray(jcarry[3]))
    jst = jstats
    for field in ("episodes", "wins_black", "wins_white", "draws", "terminated",
                  "truncated", "total_ply"):
        assert getattr(stats.base, field) == int(getattr(jst.base, field)), field
    for field in ("opp_wins", "opp_losses", "opp_draws"):
        assert getattr(stats, field) == np.asarray(getattr(jst, field)).tolist(), field
    assert stats.parity_mismatch == int(jst.parity_mismatch) == 0


@pytest.mark.parametrize("name", REAL)
def test_two_ranks_match_jax(real_ranks, name):
    """Two ranks over gloo, K=4: each holds two whole opponent blocks; on
    the compact path each also holds one whole half, so a rank runs no
    learner forward on the plies of the other half."""
    refs, out = real_ranks
    parts = [o[name] for o in out]
    summed = parts[0]["summed"]
    assert parts[1]["summed"] == summed
    local = [p["local"] for p in parts]
    assert summed.base.episodes == sum(s.base.episodes for s in local)
    if name.startswith("compact"):
        # rank 0 holds [0, N/2): the learner moves there only on even plies
        assert {c[0] % 2 for c in parts[0]["calls"] if c[1] == "learner"} == {0}
        assert {c[0] % 2 for c in parts[1]["calls"] if c[1] == "learner"} == {1}
    _assert_matches_jax(name, _concat(parts), summed, refs[name][1])


@pytest.mark.parametrize("name", [n for n in CASES if n not in REAL])
def test_block_spanning_ranks_matches_jax(monkeypatch, name):
    """K=2 over W=4: each opponent block spans two ranks. Each rank's
    columns run in turn in this process; the counts are summed by hand."""
    case, ref = _case(monkeypatch, name)
    W = CASES[name][-1]
    parts = [R.league_rollout(case, R.simulated_mesh(r, W)) for r in range(W)]
    local = [p["local"] for p in parts]
    K = case["K"]

    def total(field, k=None):
        return sum(getattr(s, field) if k is None else getattr(s, field)[k] for s in local)

    stats = type(local[0])(
        base=type(local[0].base)(*[sum(getattr(s.base, f) for s in local)
                                   for f in local[0].base.__dataclass_fields__]),
        opp_wins=[total("opp_wins", k) for k in range(K)],
        opp_losses=[total("opp_losses", k) for k in range(K)],
        opp_draws=[total("opp_draws", k) for k in range(K)],
        parity_mismatch=total("parity_mismatch"))
    _assert_matches_jax(name, _concat(parts), stats, ref)

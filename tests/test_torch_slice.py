"""The self-play slice as a whole: the port's rollout against the JAX fused
rollout, and the port's trainer through its normal entry point on the CPU.

The JAX rollout runs its fused forward with the Pallas kernels interpreted;
the port's rollout runs its fused forward (the kernels' plain versions on
the CPU) with JAX's sampled actions forced through the `sampler` hook, so
the two see the same games.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from keisei_tpu.env.vec_env import EnvCore as JaxEnvCore
from keisei_tpu.models.fused_infer import make_fused_forward as jax_make_fused_forward
from keisei_tpu.models.registry import build_model as jax_build_model
from keisei_tpu.training.rollout import make_selfplay_rollout as jax_make_rollout
from keisei_tpu.training.value_adapter import MultiHeadValueAdapter as JaxAdapter
from keisei_tpu_torch.env.vec_env import EnvCore
from keisei_tpu_torch.models.convert import flax_to_torch
from keisei_tpu_torch.models.fused_infer import make_fused_forward
from keisei_tpu_torch.models.registry import build_model
from keisei_tpu_torch.training.config import load_config
from keisei_tpu_torch.training.loop import SelfPlayTrainer, main
from keisei_tpu_torch.training.rollout import make_selfplay_rollout
from keisei_tpu_torch.training.value_adapter import get_value_adapter

torch.set_num_threads(2)

TINY = {"num_blocks": 2, "channels": 32, "global_pool_channels": 16, "se_reduction": 4}
T, N, MAX_PLY = 8, 8, 5  # max_ply 5: every env truncates at t=4 and resets


def test_rollout_matches_jax_fused_rollout():
    """Engine outputs exactly; model outputs at the bf16 fused-forward
    tolerance: values and next_value atol 0.1 (the TestFusedForward value
    bound), log-probs atol 0.3 (two logits each within 0.15)."""
    jmodel, jcfg = jax_build_model("se_resnet", TINY)
    variables = jax.device_get(jmodel.init(jax.random.key(0), jnp.zeros((2, 50, 9, 9)),
                                           train=False))
    jadapter = JaxAdapter(lambda_value=1.5, lambda_score=0.1, score_blend_alpha=0.1)
    jenv = JaxEnvCore(N, MAX_PLY, 50)
    jroll = jax.jit(jax_make_rollout(
        jenv, jmodel, jadapter, T,
        forward_fn=jax_make_fused_forward(jcfg, batch_tile=8, interpret=True)))
    (_, jobs, jmask, _), jtraj, jnext, jstats = jroll(
        jax.tree.map(jnp.asarray, variables), *jenv.init(), jax.random.key(1))

    tmodel, cfg = build_model("se_resnet", TINY)
    tmodel.load_state_dict(flax_to_torch(variables["params"], variables["batch_stats"]))
    env = EnvCore(N, MAX_PLY, 50)
    jactions = torch.from_numpy(np.asarray(jtraj.actions).astype(np.int64))
    roll = make_selfplay_rollout(
        env, tmodel, get_value_adapter("katago", lambda_value=1.5, lambda_score=0.1,
                                       score_blend_alpha=0.1),
        T, forward_fn=make_fused_forward(cfg))
    (_, tobs, tmask), traj, tnext, tstats = roll(*env.init(), None,
                                                  sampler=lambda t, masks: jactions[t])

    for name in ("obs", "actions", "rewards", "dones", "terminated", "legal_masks",
                 "value_cats", "score_targets"):
        np.testing.assert_array_equal(getattr(traj, name).numpy(),
                                      np.asarray(getattr(jtraj, name)), err_msg=name)
    np.testing.assert_array_equal(tobs.numpy(), np.asarray(jobs))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    jov = np.asarray(jtraj.next_value_override)
    tov = traj.next_value_override.numpy()
    np.testing.assert_array_equal(np.isnan(tov), np.isnan(jov))
    np.testing.assert_allclose(tov, jov, atol=0.1)
    assert np.asarray(jtraj.dones).any() and not np.isnan(jov[MAX_PLY - 1]).all()
    np.testing.assert_allclose(traj.values.numpy(), np.asarray(jtraj.values), atol=0.1)
    np.testing.assert_allclose(tnext.numpy(), np.asarray(jnext), atol=0.1)
    np.testing.assert_allclose(traj.log_probs.numpy(), np.asarray(jtraj.log_probs), atol=0.3)
    for name in ("episodes", "wins_black", "wins_white", "draws", "terminated", "truncated",
                 "total_ply"):
        assert getattr(tstats, name) == int(getattr(jstats, name)), name


TOML = """
[model]
architecture = "se_resnet"
[model.params]
num_blocks = 2
channels = 32
global_pool_channels = 16
se_reduction = 4
[training]
num_games = 4
max_ply = 12
steps_per_epoch = 8
checkpoint_interval = 2
checkpoint_dir = "{ckpt}"
rollout_forward = "{forward}"
[training.algorithm_params]
batch_size = 16
epochs_per_batch = 2
[display]
db_path = "{db}"
"""


@pytest.mark.parametrize("forward", ["fused", "auto"])
def test_trainer_two_epochs_on_cpu(tmp_path, forward):
    path = tmp_path / "tiny.toml"
    path.write_text(TOML.format(ckpt=tmp_path / "ck", forward=forward, db=tmp_path / "k.db"))
    seen = []
    trainer = SelfPlayTrainer(load_config(str(path)), device="cpu", metrics_sink=seen.append)
    trainer.run(2)
    assert [m["epoch"] for m in seen] == [1, 2]
    for m in seen:
        for k in ("policy_loss", "value_loss", "score_loss", "entropy", "gradient_norm"):
            assert math.isfinite(m[k]), (k, m[k])
    assert sorted(p.name for p in (tmp_path / "ck").iterdir()) == ["epoch_000002"]

    # resume picks up the checkpoint with identical parameters
    again = SelfPlayTrainer(load_config(str(path)), device="cpu")
    assert again.epoch == 2
    for (k, a), b in zip(trainer.model.state_dict().items(), again.model.state_dict().values()):
        assert torch.equal(a, b), k


def test_main_entry_point(tmp_path):
    path = tmp_path / "tiny.toml"
    path.write_text(TOML.format(ckpt=tmp_path / "ck", forward="fused", db=""))
    main(["--config", str(path), "--epochs", "1", "--device", "cpu", "--steps-per-epoch", "4"])
    assert (tmp_path / "ck" / "epoch_000001" / "state.pt").exists()

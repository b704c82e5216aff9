"""Guards of the port: no JAX anywhere in keisei_tpu_torch, no silent device
fallback, and clear refusals for what is not ported yet."""

import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from keisei_tpu_torch.training.config import config_from_dict
from keisei_tpu_torch.training.loop import SelfPlayTrainer
from keisei_tpu_torch.utils.device import resolve_device

TINY_MODEL = {"architecture": "se_resnet",
              "params": {"num_blocks": 1, "channels": 16, "global_pool_channels": 8,
                         "se_reduction": 4}}


def test_port_imports_no_jax():
    """A fresh interpreter imports every keisei_tpu_torch module; none of
    jax, flax, optax or orbax may be loaded afterwards."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import keisei_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(keisei_tpu_torch.__path__,
                                                        "keisei_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        bad = sorted(k for k in sys.modules if k.split(".")[0] in ("jax", "flax", "optax", "orbax"))
        print(len(names), bad)
        sys.exit(1 if bad or len(names) < 20 else 0)
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_cuda_request_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SelfPlayTrainer(config_from_dict({"model": TINY_MODEL}), device="cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_cuda_kernels_refuse_cpu_fallback_on_other_devices():
    from keisei_tpu_torch.ops.conv3x3 import conv3x3_hwbc

    x = torch.zeros(9, 9, 2, 8, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        conv3x3_hwbc(x, torch.zeros(3, 3, 8, 128, dtype=torch.bfloat16, device="meta"))


def test_int8_forward_not_yet_ported(tmp_path):
    cfg = config_from_dict({"model": TINY_MODEL, "training": {
        "num_games": 2, "rollout_forward": "int8", "checkpoint_dir": str(tmp_path)}})
    with pytest.raises(NotImplementedError, match="not yet ported"):
        SelfPlayTrainer(cfg, device="cpu")


def test_league_mode_not_yet_ported():
    with pytest.raises(NotImplementedError, match="not yet ported"):
        config_from_dict({"model": TINY_MODEL, "league": {"opponents_per_epoch": 2}})
    assert config_from_dict({"model": TINY_MODEL, "league": {"enabled": False}})


def test_multi_device_not_yet_ported(tmp_path):
    cfg = config_from_dict({"model": TINY_MODEL, "distributed": {"num_devices": 4},
                            "training": {"checkpoint_dir": str(tmp_path)}})
    with pytest.raises(NotImplementedError, match="not yet ported"):
        SelfPlayTrainer(cfg, device="cpu")


@pytest.mark.parametrize("name", ["katago-b40c256", "katago-b10c128"])
def test_loader_reads_the_repo_configs(name):
    """The port's loader reads the same TOML files into the same values as
    the JAX package's loader."""
    from keisei_tpu.training.config import load_config as jax_load_config
    from keisei_tpu_torch.training.config import load_config

    path = str(Path(__file__).resolve().parents[1] / "configs" / f"{name}.toml")
    ours, theirs = load_config(path), jax_load_config(path)
    for section in ("model", "training", "algorithm_params", "display", "run", "distributed"):
        assert vars(getattr(ours, section)) == vars(getattr(theirs, section)), section


def test_loader_rejects_unknown_keys():
    with pytest.raises(ValueError, match="unknown key"):
        config_from_dict({"training": {"bogus": 1}})
    with pytest.raises(ValueError, match="rollout_forward"):
        config_from_dict({"training": {"rollout_forward": "tpu"}})

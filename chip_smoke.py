"""GPU smoke run of keisei_tpu_torch: builds the CUDA kernels, checks them
against their plain PyTorch versions, checks the fused b40c256 forward
against the eager model, and trains two self-play epochs of b40c256 through
the normal entry point (SelfPlayTrainer from configs/katago-b40c256.toml).

    python3 chip_smoke.py

Needs one CUDA device and nvcc; exits non-zero without them. Every phase
prints one line of numbers; the line before the last is a JSON summary of
the kernels, the last line is {"ok": true, "device": {...}}. Any failure
raises. Imports no JAX.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import torch

TOL = 0.05            # kernel vs plain, bf16 (the TestPallasConv bound)
SMOKE_GAMES = 64
SMOKE_STEPS = 16
REPO = os.path.dirname(os.path.abspath(__file__))


def cuda_ms(fn, iters: int = 20, warmup: int = 2) -> float:
    """Mean device time of fn() in ms, by CUDA events around `iters` calls."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_errors(got: torch.Tensor, ref: torch.Tensor) -> tuple[float, float]:
    diff = (got.float() - ref.float()).abs()
    return float(diff.max()), float((diff / ref.float().abs().clamp_min(1e-3)).max())


def block_weights(c: int, gpc: int, sec: int, g: torch.Generator, dev) -> tuple:
    def rnd(*shape, scale, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(dtype)

    s = 1.0 / math.sqrt(9 * c)
    ones = torch.ones(c, device=dev)
    bn = torch.stack([ones + rnd(c, scale=0.1, dtype=torch.float32), rnd(c, scale=0.1, dtype=torch.float32),
                      ones + rnd(c, scale=0.1, dtype=torch.float32), rnd(c, scale=0.1, dtype=torch.float32)])
    return (rnd(3, 3, c, c, scale=s), rnd(3, 3, c, c, scale=s), bn.contiguous(),
            rnd(3 * c, gpc, scale=0.05), rnd(gpc, scale=0.1, dtype=torch.float32),
            rnd(gpc, c, scale=0.05), rnd(c, scale=0.1, dtype=torch.float32),
            rnd(c, sec, scale=0.05), rnd(sec, scale=0.1, dtype=torch.float32),
            rnd(sec, 2 * c, scale=0.05), rnd(2 * c, scale=0.1, dtype=torch.float32))


def main() -> int:
    # -- phase 1: the card ---------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing to run",
              file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    sys.path.insert(0, REPO)
    from keisei_tpu_torch.env.vec_env import EnvCore
    from keisei_tpu_torch.models.fused_infer import make_fused_forward
    from keisei_tpu_torch.models.registry import build_model
    from keisei_tpu_torch.ops import _build
    from keisei_tpu_torch.ops.conv3x3 import conv3x3_hwbc, conv3x3_hwbc_reference
    from keisei_tpu_torch.ops.fused_block import (fused_gpbias_block,
                                                  fused_gpbias_block_reference)
    from keisei_tpu_torch.training.checkpoint import load_checkpoint
    from keisei_tpu_torch.training.config import load_config
    from keisei_tpu_torch.training.loop import SelfPlayTrainer
    from keisei_tpu_torch.training.ppo import make_optimizer

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"phase1 device={torch.cuda.get_device_name(0)} count={torch.cuda.device_count()} "
          f"torch={torch.__version__} cuda={torch.version.cuda}")

    # -- phase 2: build ------------------------------------------------------
    t0 = time.monotonic()
    _build.load_library()
    print(f"phase2 build_s={time.monotonic() - t0:.2f} dir={_build.build_dir()}")

    # -- phase 3: kernels vs plain versions on the card ----------------------
    g = torch.Generator(device=dev).manual_seed(0)
    kernels = {}
    for b in (64, 256):
        for cin in (50, 256):
            x = torch.randn(9, 9, b, cin, generator=g, device=dev).to(torch.bfloat16)
            w = (torch.randn(3, 3, cin, 256, generator=g, device=dev)
                 / math.sqrt(9 * cin)).to(torch.bfloat16)
            got = conv3x3_hwbc(x, w)
            ref = conv3x3_hwbc_reference(x, w)
            torch.cuda.synchronize()
            abs_err, rel_err = max_errors(got, ref)
            ok = torch.allclose(got.float(), ref.float(), rtol=TOL, atol=TOL)
            ms = cuda_ms(lambda: conv3x3_hwbc(x, w))
            plain_ms = cuda_ms(lambda: conv3x3_hwbc_reference(x, w))
            print(f"phase3 conv3x3 B={b} Cin={cin} Cout=256 max_abs_err={abs_err:.4g} "
                  f"max_rel_err={rel_err:.4g} tol={TOL} ms={ms:.4f} plain_ms={plain_ms:.4f}")
            if not ok:
                raise AssertionError(f"conv3x3 B={b} Cin={cin} disagrees with its plain version")
            if b == SMOKE_GAMES and cin == 50:  # the input conv of the main path
                kernels["conv3x3_hwbc"] = dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms)
        # 40 distinct weight sets, as in one b40c256 trunk: weights stream from HBM
        blocks = [block_weights(256, 128, 16, g, dev) for _ in range(40)]
        x = torch.relu(torch.randn(9, 9, b, 256, generator=g, device=dev)).to(torch.bfloat16)
        got = fused_gpbias_block(x, *blocks[0])
        ref = fused_gpbias_block_reference(x, *blocks[0])
        torch.cuda.synchronize()
        abs_err, rel_err = max_errors(got, ref)
        ok = torch.allclose(got.float(), ref.float(), rtol=TOL, atol=TOL)

        def trunk(fn):
            y = x
            for wts in blocks:
                y = fn(y, *wts)
            return y

        ms = cuda_ms(lambda: trunk(fused_gpbias_block), iters=5) / 40
        plain_ms = cuda_ms(lambda: trunk(fused_gpbias_block_reference), iters=2, warmup=1) / 40
        print(f"phase3 fused_gpbias_block B={b} C=256 max_abs_err={abs_err:.4g} "
              f"max_rel_err={rel_err:.4g} tol={TOL} ms={ms:.4f} plain_ms={plain_ms:.4f}")
        if not ok:
            raise AssertionError(f"fused block B={b} disagrees with its plain version")
        if b == SMOKE_GAMES:
            kernels["fused_gpbias_block"] = dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms)
        del blocks

    # the rules engine on the card against the same engine on the CPU
    rng = torch.Generator().manual_seed(1)
    envs = {d: EnvCore(SMOKE_GAMES, 40, 50, d) for d in ("cpu", "cuda")}
    carry = {d: envs[d].init() for d in envs}
    ended = 0
    for ply in range(48):
        mask = carry["cpu"][2]
        actions = torch.multinomial(mask.float(), 1, generator=rng)[:, 0]
        outs = {}
        for d in envs:
            s, o = envs[d].step(carry[d][0], actions.to(d))
            carry[d] = (s, o.obs, o.legal_mask)
            outs[d] = o
        for f in dataclasses.fields(outs["cpu"]):
            a, b_ = getattr(outs["cpu"], f.name), getattr(outs["cuda"], f.name).cpu()
            if not torch.equal(a, b_):
                raise AssertionError(f"engine on the card differs from the CPU at ply {ply}: {f.name}")
        if not torch.equal(carry["cpu"][0].hash_hist, carry["cuda"][0].hash_hist.cpu()):
            raise AssertionError(f"hash history differs at ply {ply}")
        ended += int((outs["cpu"].terminated | outs["cpu"].truncated).sum())
    print(f"phase3 engine cuda==cpu plies=48 envs={SMOKE_GAMES} episodes_ended={ended}")

    # -- phase 4: fused b40c256 forward vs the eager model ---------------------
    cfg_path = os.path.join(REPO, "configs", "katago-b40c256.toml")
    config = load_config(cfg_path)
    torch.manual_seed(0)
    model, mcfg = build_model(config.model.architecture, config.model.params)
    with torch.no_grad():  # non-trivial BatchNorm folds
        for mod in model.modules():
            if hasattr(mod, "running_var"):
                mod.running_var.copy_(torch.exp(torch.randn_like(mod.running_var) * 0.2))
                mod.running_mean.copy_(torch.randn_like(mod.running_mean) * 0.1)
    model.to(dev).eval()
    fwd = make_fused_forward(mcfg)
    weights = fwd.prepare(model)
    for b in (64, 256):
        obs = (torch.rand(b, 50, 9, 9, generator=g, device=dev) > 0.8).float()
        with torch.no_grad():
            got = fwd(weights, obs)
            ref = model(obs)
        p_ok = torch.allclose(got.policy_logits, ref.policy_logits, rtol=0.1, atol=0.15)
        v_ok = torch.allclose(got.value_logits, ref.value_logits, rtol=0.1, atol=0.1)
        s_ok = torch.allclose(got.score_lead, ref.score_lead, rtol=0.1, atol=0.1)
        agree = float((got.policy_logits.reshape(b, -1).argmax(1)
                       == ref.policy_logits.reshape(b, -1).argmax(1)).float().mean())
        fused_ms = cuda_ms(lambda: fwd(weights, obs), iters=5)
        with torch.no_grad():
            eager_ms = cuda_ms(lambda: model(obs), iters=5)
        print(f"phase4 b40c256 B={b} policy_max_abs_err="
              f"{float((got.policy_logits - ref.policy_logits).abs().max()):.4g} "
              f"value_max_abs_err={float((got.value_logits - ref.value_logits).abs().max()):.4g} "
              f"score_max_abs_err={float((got.score_lead - ref.score_lead).abs().max()):.4g} "
              f"top1_agree={agree:.3f} fused_forward_ms={fused_ms:.3f} eager_forward_ms={eager_ms:.3f}")
        if not (p_ok and v_ok and s_ok and agree >= 0.7):
            raise AssertionError(f"fused b40c256 forward disagrees with the eager model at B={b}")
    del model, weights

    # -- phase 5: two self-play epochs through the trainer ----------------------
    with tempfile.TemporaryDirectory() as tmp:
        tc = dataclasses.replace(config.training, rollout_forward="fused", num_games=SMOKE_GAMES,
                                 steps_per_epoch=SMOKE_STEPS, checkpoint_interval=2,
                                 checkpoint_dir=os.path.join(tmp, "ck"))
        ap = dataclasses.replace(config.algorithm_params, batch_size=256, epochs_per_batch=1)
        smoke_cfg = dataclasses.replace(config, training=tc, algorithm_params=ap,
                                        display=dataclasses.replace(config.display, db_path=""))
        seen = []
        trainer = SelfPlayTrainer(smoke_cfg, device="cuda", metrics_sink=seen.append)
        conv3x3_hwbc.launches = 0
        fused_gpbias_block.launches = 0
        trainer.run(2)
        torch.cuda.synchronize()
        launches = {"conv3x3_hwbc": conv3x3_hwbc.launches,
                    "fused_gpbias_block": fused_gpbias_block.launches}
        for m in seen:
            steps = SMOKE_GAMES * SMOKE_STEPS
            print(f"phase5 epoch={m['epoch']} rollout_s={m['rollout_time']:.3f} "
                  f"update_s={m['update_time']:.3f} env_steps_per_s={steps / m['rollout_time']:.1f} "
                  f"policy_loss={m['policy_loss']:.4f} value_loss={m['value_loss']:.4f} "
                  f"entropy={m['entropy']:.3f} grad_norm={m['gradient_norm']:.4f} "
                  f"episodes={m['episodes']}")
            for k in ("policy_loss", "value_loss", "score_loss", "entropy", "gradient_norm"):
                if not math.isfinite(m[k]):
                    raise AssertionError(f"epoch {m['epoch']}: {k} = {m[k]}")
        forwards = (SMOKE_STEPS + 1) * 2
        print(f"phase5 launches conv3x3_hwbc={launches['conv3x3_hwbc']} "
              f"fused_gpbias_block={launches['fused_gpbias_block']} min_forwards={forwards}")
        if launches["fused_gpbias_block"] < 40 * forwards or launches["conv3x3_hwbc"] < forwards:
            raise AssertionError(f"the main path did not go through the kernels: {launches}")
        ckpts = sorted(os.listdir(tc.checkpoint_dir))
        if ckpts != ["epoch_000002"]:
            raise AssertionError(f"expected one checkpoint, found {ckpts}")
        fresh, _ = build_model(config.model.architecture, config.model.params)
        fresh.to(dev)
        load_checkpoint(os.path.join(tc.checkpoint_dir, ckpts[0]), fresh,
                        make_optimizer(fresh, ap), torch.Generator(device=dev),
                        architecture=config.model.architecture)
        want = trainer.model.state_dict()
        for k, v in fresh.state_dict().items():
            if not torch.equal(v, want[k]):
                raise AssertionError(f"checkpoint reload differs at {k}")
        print(f"phase5 checkpoint={ckpts[0]} reload=identical "
              f"tensors={len(want)} peak_mem_gb={torch.cuda.max_memory_allocated() / 1e9:.2f}")

    sources = {"conv3x3_hwbc": ("keisei_tpu_torch/csrc/conv3x3.cu", "keisei_tpu/ops/conv3x3.py:69"),
               "fused_gpbias_block": ("keisei_tpu_torch/csrc/fused_block.cu",
                                      "keisei_tpu/ops/fused_block.py:124")}
    summary = [{"name": name, "route": "cuda", "source": sources[name][0],
                "replaces": sources[name][1], "launches": launches[name], **kernels[name]}
               for name in ("conv3x3_hwbc", "fused_gpbias_block")]
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

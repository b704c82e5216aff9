"""GPU smoke run of keisei_tpu_torch: builds the CUDA kernels, checks each
against its plain PyTorch version, checks the fused bf16 and the int8
b40c256 forwards, trains two self-play epochs of b40c256 through the normal
entry point (SelfPlayTrainer from configs/katago-b40c256.toml) with the
fused forward and two with the int8 forward, and runs the tensor-core rate
probe (keisei_tpu_torch/scripts/profile_int8_mma.py).

    python3 chip_smoke.py

Needs one CUDA device and nvcc; exits non-zero without them. Every phase
prints lines of numbers; the line before the last is a JSON summary of the
kernels, the last line is {"ok": true, "device": {...}}. Any failure
raises. Imports no JAX.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import sys
import tempfile
import time

import torch
import torch.nn.functional as F

TOL = 0.05            # bf16 kernel vs plain (the TestPallasConv bound)
SMOKE_GAMES = 64
SMOKE_STEPS = 16
REPO = os.path.dirname(os.path.abspath(__file__))
# H100 SXM dense peaks (NVIDIA data sheet) and HBM3 rate, per second
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12}
PEAK_BYTES = 3.35e12


def bound(ops: dict[str, float], nbytes: float) -> dict:
    """The least time the card could take: the larger of the operations
    over their type's peak and the bytes over the memory rate."""
    t_ops = sum(n / PEAK_OPS[kind] for kind, n in ops.items())
    t_bytes = nbytes / PEAK_BYTES
    return {"bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


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


def fc_ops(b: int, c: int, gpc: int, sec: int) -> float:
    """Operations of a block's four in-block FCs."""
    return 2.0 * b * (3 * c * gpc + gpc * c + c * sec + sec * 2 * c)


def fc_bytes(c: int, gpc: int, sec: int) -> float:
    """Bytes of a block's FC kernels (bf16), their biases and the BN rows (f32)."""
    return 2.0 * (3 * c * gpc + gpc * c + c * sec + sec * 2 * c) + 4.0 * (gpc + c + sec + 2 * c + 4 * c)


def main() -> int:
    # -- phase 1: the card ---------------------------------------------------
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing to run",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from keisei_tpu_torch.env.vec_env import EnvCore
    from keisei_tpu_torch.models.fused_infer import make_fused_forward, make_quantized_forward
    from keisei_tpu_torch.models.registry import build_model
    from keisei_tpu_torch.ops import _build
    from keisei_tpu_torch.ops.conv3x3 import conv3x3_hwbc, conv3x3_hwbc_reference
    from keisei_tpu_torch.ops.fused_block import (fused_gpbias_block,
                                                  fused_gpbias_block_reference)
    from keisei_tpu_torch.ops.qblock import (pack_quantized, quantize_conv_weights,
                                             quantized_gpbias_block,
                                             quantized_gpbias_block_reference,
                                             unpack_dequantized)
    from keisei_tpu_torch.scripts import profile_int8_mma as probe
    from keisei_tpu_torch.training.checkpoint import load_checkpoint
    from keisei_tpu_torch.training.config import load_config
    from keisei_tpu_torch.training.loop import SelfPlayTrainer
    from keisei_tpu_torch.training.ppo import make_optimizer
    from keisei_tpu_torch.utils.timing import card, cuda_ms

    card_line = card()
    print(card_line)
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
    gpc, sec = 128, 16  # b40c256: global_pool_channels 128, se_reduction 16
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
            # the library yardstick: cuDNN's bf16 conv, channels_last, same shapes
            x_cl = x.permute(2, 3, 0, 1).contiguous(memory_format=torch.channels_last)
            w_cl = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
            library_ms = cuda_ms(lambda: F.conv2d(x_cl, w_cl, padding=1))
            print(f"phase3 conv3x3 B={b} Cin={cin} Cout=256 max_abs_err={abs_err:.4g} "
                  f"max_rel_err={rel_err:.4g} tol={TOL} ms={ms:.4f} plain_ms={plain_ms:.4f} "
                  f"library_ms={library_ms:.4f}")
            if not ok:
                raise AssertionError(f"conv3x3 B={b} Cin={cin} disagrees with its plain version")
            if b == SMOKE_GAMES and cin == 50:  # the input conv of the main path
                kernels["conv3x3_hwbc"] = dict(
                    max_abs_err=abs_err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                    **bound({"bf16": 2.0 * 81 * b * 9 * cin * 256},
                            2.0 * (81 * b * cin + 9 * cin * 256 + 81 * b * 256)))
        # 40 distinct weight sets, as in one b40c256 trunk: weights stream from HBM
        blocks = [block_weights(256, gpc, sec, g, dev) for _ in range(40)]
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
            kernels["fused_gpbias_block"] = dict(
                max_abs_err=abs_err, ms=ms, plain_ms=plain_ms, library_ms=None,
                **bound({"bf16": 2 * 2.0 * 81 * b * 9 * 256 * 256 + fc_ops(b, 256, gpc, sec)},
                        2 * 2.0 * 81 * b * 256 + 2 * 2.0 * 9 * 256 * 256 + fc_bytes(256, gpc, sec)))

        # the int8 block over the same 40 weight sets, quantized as the
        # int8 forward's prepare does; each set is held to its plain version
        # at the card-test bound: outputs at most 1 level apart, >= 99%
        # identical, scales within rtol 1e-4
        qblocks = []
        for w1, w2, bn, *fcs in blocks:
            wq1, ws1 = quantize_conv_weights(w1)
            wq2, ws2 = quantize_conv_weights(w2)
            qblocks.append((wq1, wq2, torch.stack([bn[0] * ws1, bn[1], bn[2] * ws2, bn[3]]),
                            *fcs))
        del blocks
        xq, sx = pack_quantized(x.float(), 32)
        worst = {"levels": 0, "identical": 1.0, "scale_rel": 0.0, "abs": 0.0}
        for wts in qblocks:
            yq, sy = quantized_gpbias_block(xq, sx, *wts, batch_tile=32)
            rq, rs = quantized_gpbias_block_reference(xq, sx, *wts, batch_tile=32)
            torch.cuda.synchronize()
            diff = (yq.int() - rq.int()).abs()
            worst["levels"] = max(worst["levels"], int(diff.max()))
            worst["identical"] = min(worst["identical"], float((diff == 0).float().mean()))
            worst["scale_rel"] = max(worst["scale_rel"], float(((sy - rs).abs() / rs).max()))
            worst["abs"] = max(worst["abs"], float((unpack_dequantized(yq, sy, 32)
                                                    - unpack_dequantized(rq, rs, 32)).abs().max()))

        def qtrunk(fn):
            y, s = xq, sx
            for wts in qblocks:
                y, s = fn(y, s, *wts, batch_tile=32)
            return y

        ms = cuda_ms(lambda: qtrunk(quantized_gpbias_block), iters=5) / 40
        plain_ms = cuda_ms(lambda: qtrunk(quantized_gpbias_block_reference), iters=2,
                           warmup=1) / 40
        print(f"phase3 quantized_gpbias_block B={b} C=256 bt=32 weight_sets=40 "
              f"max_level_diff={worst['levels']} min_identical={worst['identical']:.5f} "
              f"max_scale_rel_err={worst['scale_rel']:.3g} max_abs_err={worst['abs']:.4g} "
              f"ms={ms:.4f} plain_ms={plain_ms:.4f}")
        if worst["levels"] > 1 or worst["identical"] < 0.99 or worst["scale_rel"] > 1e-4:
            raise AssertionError(f"int8 block B={b} disagrees with its plain version: {worst}")
        if b == SMOKE_GAMES:
            kernels["quantized_gpbias_block"] = dict(
                max_abs_err=worst["abs"], ms=ms, plain_ms=plain_ms, library_ms=None,
                **bound({"int8": 2 * 2.0 * 81 * b * 9 * 256 * 256,
                         "bf16": fc_ops(b, 256, gpc, sec)},
                        2.0 * 81 * b * 256 + 2 * 9.0 * 256 * 256 + fc_bytes(256, gpc, sec)
                        + 4.0 * 2 * (b // 32)))
        del qblocks

    # the tensor-core rate probe against its plain version (exact)
    probe.check(dev)
    a, bmat = probe.probe_inputs(torch.int8, probe.M, dev, seed=1)
    probe_plain_ms = cuda_ms(lambda: probe.mma_chain_reference(a, bmat, probe.CHAIN),
                             iters=2, warmup=1)
    del a, bmat
    print(f"phase3 mma_chain int8+bf16 chain=3 rows={2 * probe.ROWS} exact=True "
          f"plain_ms(M={probe.M}, chain={probe.CHAIN})={probe_plain_ms:.3f}")

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

    # -- phase 4: fused and int8 b40c256 forwards -------------------------------
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
    f32_model, _ = build_model(config.model.architecture,
                               {**config.model.params, "dtype": "float32"})
    f32_model.load_state_dict(model.state_dict())
    f32_model.to(dev).eval()
    fwd = make_fused_forward(mcfg)
    weights = fwd.prepare(model)
    qfwd = make_quantized_forward(mcfg)
    qweights = qfwd.prepare(model)
    qplain = make_quantized_forward(mcfg)
    qplain.block_fn = quantized_gpbias_block_reference
    for b in (64, 256):
        obs = (torch.rand(b, 50, 9, 9, generator=g, device=dev) > 0.8).float()
        with torch.no_grad():
            got = fwd(weights, obs)
            ref = model(obs)
            truth = f32_model(obs)
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

        # int8: the kernel path against the same forward with the plain int8
        # block (hard gate: the TestFusedForward allclose bounds on all three
        # outputs), then against the eager f32 model (reported; gated on
        # finite outputs only). Top-1 agreement is printed, not gated: the
        # untrained net's 11,259 logits are nearly tied, and one-level int8
        # rounding flips carried through 40 blocks move them by more than
        # their margins (measured on the H100: 0.625 against the plain int8
        # forward, with every logit within 0.066 of it).
        q = qfwd(qweights, obs)
        qp = qplain(qweights, obs)
        torch.cuda.synchronize()
        errs = {k: float((getattr(q, k) - getattr(qp, k)).abs().max())
                for k in ("policy_logits", "value_logits", "score_lead")}
        qp_agree = float((q.policy_logits.reshape(b, -1).argmax(1)
                          == qp.policy_logits.reshape(b, -1).argmax(1)).float().mean())
        t_pol = truth.policy_logits.reshape(b, -1)
        scale = float(t_pol.abs().max())
        q_err = float((q.policy_logits.reshape(b, -1) - t_pol).abs().max()) / scale
        bf_err = float((got.policy_logits.reshape(b, -1) - t_pol).abs().max()) / scale
        q_top1 = float((q.policy_logits.reshape(b, -1).argmax(1) == t_pol.argmax(1)).float().mean())
        q_verr = float((q.value_logits - truth.value_logits).abs().max())
        int8_ms = cuda_ms(lambda: qfwd(qweights, obs), iters=5)
        print(f"phase4 int8 b40c256 B={b} vs_plain_int8: policy_max_abs_err="
              f"{errs['policy_logits']:.4g} value_max_abs_err={errs['value_logits']:.4g} "
              f"score_max_abs_err={errs['score_lead']:.4g} top1_agree={qp_agree:.3f}; "
              f"vs_f32: policy_rel_err={q_err:.4g} (fused bf16 {bf_err:.4g}) top1_agree={q_top1:.3f} "
              f"value_max_abs_err={q_verr:.4g}; int8_forward_ms={int8_ms:.3f} "
              f"fused_forward_ms={fused_ms:.3f}")
        plain_ok = (torch.allclose(q.policy_logits, qp.policy_logits, rtol=0.1, atol=0.15)
                    and torch.allclose(q.value_logits, qp.value_logits, rtol=0.1, atol=0.1)
                    and torch.allclose(q.score_lead, qp.score_lead, rtol=0.1, atol=0.1))
        finite = all(bool(torch.isfinite(getattr(q, k)).all())
                     for k in ("policy_logits", "value_logits", "score_lead"))
        if not (plain_ok and finite):
            raise AssertionError(f"int8 b40c256 forward disagrees with its plain version at B={b}")
    del model, f32_model, weights, qweights

    # -- phase 5: two self-play epochs per rollout forward through the trainer --
    launches = {}
    for mode in ("fused", "int8"):
        with tempfile.TemporaryDirectory() as tmp:
            tc = dataclasses.replace(config.training, rollout_forward=mode, num_games=SMOKE_GAMES,
                                     steps_per_epoch=SMOKE_STEPS, checkpoint_interval=2,
                                     checkpoint_dir=os.path.join(tmp, "ck"))
            ap = dataclasses.replace(config.algorithm_params, batch_size=256, epochs_per_batch=1)
            smoke_cfg = dataclasses.replace(config, training=tc, algorithm_params=ap,
                                            display=dataclasses.replace(config.display, db_path=""))
            seen = []
            trainer = SelfPlayTrainer(smoke_cfg, device="cuda", metrics_sink=seen.append)
            conv3x3_hwbc.launches = 0
            fused_gpbias_block.launches = 0
            quantized_gpbias_block.launches = 0
            trainer.run(2)
            torch.cuda.synchronize()
            counts = {"conv3x3_hwbc": conv3x3_hwbc.launches,
                      "fused_gpbias_block": fused_gpbias_block.launches,
                      "quantized_gpbias_block": quantized_gpbias_block.launches}
            for m in seen:
                steps = SMOKE_GAMES * SMOKE_STEPS
                print(f"phase5 {mode} epoch={m['epoch']} rollout_s={m['rollout_time']:.3f} "
                      f"update_s={m['update_time']:.3f} "
                      f"env_steps_per_s={steps / m['rollout_time']:.1f} "
                      f"policy_loss={m['policy_loss']:.4f} value_loss={m['value_loss']:.4f} "
                      f"entropy={m['entropy']:.3f} grad_norm={m['gradient_norm']:.4f} "
                      f"episodes={m['episodes']}")
                for k in ("policy_loss", "value_loss", "score_loss", "entropy", "gradient_norm"):
                    if not math.isfinite(m[k]):
                        raise AssertionError(f"{mode} epoch {m['epoch']}: {k} = {m[k]}")
            forwards = (SMOKE_STEPS + 1) * 2
            block = "fused_gpbias_block" if mode == "fused" else "quantized_gpbias_block"
            other = "quantized_gpbias_block" if mode == "fused" else "fused_gpbias_block"
            print(f"phase5 {mode} launches conv3x3_hwbc={counts['conv3x3_hwbc']} "
                  f"{block}={counts[block]} {other}={counts[other]} min_forwards={forwards}")
            if counts[block] < 40 * forwards or counts["conv3x3_hwbc"] < forwards or counts[other]:
                raise AssertionError(f"the {mode} path did not go through its kernels: {counts}")
            if mode == "fused":
                launches.update(conv3x3_hwbc=counts["conv3x3_hwbc"],
                                fused_gpbias_block=counts[block])
            else:
                launches["quantized_gpbias_block"] = counts[block]
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
            print(f"phase5 {mode} checkpoint={ckpts[0]} reload=identical tensors={len(want)} "
                  f"peak_mem_gb={torch.cuda.max_memory_allocated() / 1e9:.2f}")
            del trainer, fresh

    # -- phase 6: the tensor-core rate probe through its own entry ---------------
    probe.mma_chain.launches = 0
    res = probe.measure(dev)
    launches["mma_chain"] = probe.mma_chain.launches
    r8, r16 = res["int8"], res["bf16"]
    print(f"phase6 probe {card_line} M={probe.M} K={probe.K} "
          f"chain={probe.CHAIN} int8_ms={r8['ms']:.4f} int8_TOPs={r8['rate'] / 1e12:.1f} "
          f"({100 * r8['peak_share']:.1f}% of 1979) bf16_ms={r16['ms']:.4f} "
          f"bf16_TFLOPs={r16['rate'] / 1e12:.1f} ({100 * r16['peak_share']:.1f}% of 989) "
          f"launches={launches['mma_chain']}")
    if launches["mma_chain"] < 1:
        raise AssertionError("the probe did not launch its kernel")
    kernels["mma_chain"] = dict(
        max_abs_err=0.0, ms=r8["ms"], plain_ms=probe_plain_ms, library_ms=None,
        **bound({"int8": r8["ops"]}, 2.0 * probe.M * probe.K + probe.K * probe.K))

    sources = {
        "conv3x3_hwbc": ("keisei_tpu_torch/csrc/conv3x3.cu", "keisei_tpu/ops/conv3x3.py:69"),
        "fused_gpbias_block": ("keisei_tpu_torch/csrc/fused_block.cu",
                               "keisei_tpu/ops/fused_block.py:124"),
        "quantized_gpbias_block": ("keisei_tpu_torch/csrc/qblock.cu",
                                   "keisei_tpu/ops/qblock.py:173"),
        "mma_chain": ("keisei_tpu_torch/csrc/mma_rate.cu", "scripts/profile_int8_mxu.py:71"),
    }
    summary = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
                "launches": launches[name], **kernels[name]}
               for name, (src, rep) in sources.items()]
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""GPU smoke run of keisei_tpu_torch: builds the CUDA kernels, checks each
against its plain PyTorch version, checks the fused bf16 and the int8
b40c256 forwards, trains two self-play epochs of b40c256 through the normal
entry point (SelfPlayTrainer from configs/katago-b40c256.toml) with the
fused forward and two with the int8 forward, runs the tensor-core rate
probe (keisei_tpu_torch/scripts/profile_int8_mma.py), and drives the probe
entry points whose kernels replace the TPU scripts' Pallas kernels
(scripts/debug_fused_block.py, profile_pallas_conv.py,
profile_conv_alternatives.py, profile_qblock_parts.py; profile_fused_forward
for the conv on unpadded planes): each kernel against its plain version at a
small size, then the scripts at their own sizes. Phase 8 trains league mode
(configs/katago-league.toml at full width, the cuts printed: the learner
against K frozen opponents from the tiered pool, with the maintenance after
each epoch) and drives the VecEnv host shim; phase 9 plays the league
tournament (an in-process round at full width with Dynamic updates, the
sidecar dispatcher and worker, and the round inside league training);
phase 10 runs the supervised warm start (scripts/sl_smoke.py: a corpus
played by the engine on the card, the shards encoded on the card, SL
training of b40c256, sl_to_rl and RL epochs with asynchronous saves, SL
steps at 4,096 rows); phase 11 runs the dashboard feed
(scripts/showcase_smoke.py: the spectator env on the card against the
CPU's, an exhibition game of b40c256 through the showcase runner, a
demonstrator game, the dashboard server's messages); phase 12 runs data
parallelism on the one card (scripts/parallel_smoke.py: two ranks sharing
it over gloo train league and self-play b40c256 epochs, held bit-identical
and to one process's gradient; NCCL at world size 1; the multi-device dry
run); no kernel lies on those five paths. Phase 13 checks the train
path's kernels (ops/train_bn.py: BatchNorm, the global pool and the block's
epilogues in training mode, forward and backward) against their plain
versions, times each at B=1,024, C=256, and times a block's and the b40c256
model's train step on them and on the plain path; the launches it reports
for them are phase 5's fused update's, counted from 0 (each mode of a
kernel that takes one on its own).
The 3x3 conv is checked on every route (wgmma fed by TMA for Cin % 64 == 0,
the same kernel after a zero pad of the channels for the 50 observation
planes, mma.sync with 1 / 2 / 4 boards per CTA), with the per-route launch
counter showing which one ran; the fused block (four kernels per call) and
the int8 block (six kernels per call, its convs on s8 wgmma) over 40 weight
sets at B=64/256/1024, each timed from a CUDA graph of the 40 calls with its
kernels from a trace, and over a grid of batch sizes and widths, twice with
equal bits and replayed from a CUDA graph.

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
# the fused forward's input conv: its 50 planes padded to 64 where they are cast
PADDED_STEM = "conv3x3_hwbc[50\u219264]"


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


def int8_block_diff(got: tuple, ref: tuple, bt: int) -> dict:
    """The int8 block's (yq, sy) against its plain version's: the largest
    level difference, the share of identical values, the scales' largest
    relative error and the dequantized outputs' largest abs error."""
    from keisei_tpu_torch.ops.qblock import unpack_dequantized
    (yq, sy), (rq, rs) = got, ref
    diff = (yq.int() - rq.int()).abs()
    return {"levels": int(diff.max()), "identical": float((diff == 0).float().mean()),
            "scale_rel": float(((sy - rs).abs() / rs).max()),
            "abs": float((unpack_dequantized(yq, sy, bt) - unpack_dequantized(rq, rs, bt))
                         .abs().max())}


def int8_block_ok(d: dict) -> bool:
    """The card-test bound: at most 1 level apart, >= 99% identical, scales
    within rtol 1e-4."""
    return d["levels"] <= 1 and d["identical"] >= 0.99 and d["scale_rel"] <= 1e-4


def fc_ops(b: int, c: int, gpc: int, sec: int) -> float:
    """Operations of a block's four in-block FCs."""
    return 2.0 * b * (3 * c * gpc + gpc * c + c * sec + sec * 2 * c)


def fc_bytes(c: int, gpc: int, sec: int) -> float:
    """Bytes of a block's FC kernels (bf16), their biases and the BN rows (f32)."""
    return 2.0 * (3 * c * gpc + gpc * c + c * sec + sec * 2 * c) + 4.0 * (gpc + c + sec + 2 * c + 4 * c)


def probe_phase(dev) -> tuple[dict, dict]:
    """Phase 7: the probes' kernels (rows 5-8 of PERF.md's kernel table).
    Each kernel against its plain version at a small size, with partial
    tiles, and again on the inputs the scripts time (hard gates); the plain
    and library times; single-launch times where the scripts time chains;
    then every counter set to 0 and the probe entry points driven at their
    own sizes (profile_fused_forward at the smoke's batch: it runs the input
    conv on unpadded planes, which the fused forward no longer does). Returns
    the kernels' JSON entries and their launches."""
    from keisei_tpu_torch.ops.conv3x3 import (BOARDS_PER_CTA, conv3x3_bpc, conv3x3_hwbc,
                                              conv3x3_hwbc_reference)
    from keisei_tpu_torch.ops.fused_block import STAGES, fused_block_stage
    from keisei_tpu_torch.ops.qblock import (quantized_gpbias_block,
                                             quantized_gpbias_block_reference)
    from keisei_tpu_torch.scripts import debug_fused_block as dbg
    from keisei_tpu_torch.scripts import profile_conv_alternatives as alt
    from keisei_tpu_torch.scripts import profile_direct_conv as direct
    from keisei_tpu_torch.scripts import profile_fused_forward as fused
    from keisei_tpu_torch.scripts import profile_qblock_parts as qparts
    from keisei_tpu_torch.utils.timing import cuda_ms, graph_ms

    kernels = {}
    # -- gates: each kernel against its plain version, small sizes ---------
    for c in (dbg.C, 256):
        for stage, r in dbg.run(dev, dbg.B, c).items():
            print(f"phase7 check fused_block_stage[{stage}] B={dbg.B} C={c} "
                  f"max_abs_err={r['max_abs_err']:.4g} rel_err={r['rel_err']:.4g}")
    conv_errs = direct.check(dev)
    part_errs = qparts.check(dev)
    alt_errs = alt.check(dev)
    print(f"phase7 check conv3x3_bpc B={direct.CHECK_B} C={direct.C} rel_err={conv_errs} "
          f"(< 0.02); one-hot boards equal")
    print(f"phase7 check qblock_part/dot_chain {part_errs}")
    print(f"phase7 check tiled_mm/winograd {alt_errs}")

    # -- on the inputs the scripts time: each kernel against its plain
    # version (hard gates), the plain, library and single-launch times -----
    b, c = direct.B, direct.C
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn(9, 9, b, c, generator=g, device=dev).to(torch.bfloat16)
    w = (torch.randn(3, 3, c, c, generator=g, device=dev) * 0.02).to(torch.bfloat16)
    ref = conv3x3_hwbc_reference(x, w)
    conv_plain_ms = cuda_ms(lambda: conv3x3_hwbc_reference(x, w), iters=3, warmup=1)
    x_cl = x.permute(2, 3, 0, 1).contiguous(memory_format=torch.channels_last)
    w_cl = w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    conv_library_ms = graph_ms(lambda: F.conv2d(x_cl, w_cl, padding=1))
    for bpc in BOARDS_PER_CTA:
        got = conv3x3_bpc(x, w, boards_per_cta=bpc)
        rel = direct.compare_conv(bpc, got, ref)
        abs_err = max_errors(got, ref)[0]
        print(f"phase7 check conv3x3_bpc[{bpc}] B={b} C={c} max_abs_err={abs_err:.4g} "
              f"rel_err={rel:.4g} (< 0.02)")
        ms = graph_ms(lambda: conv3x3_bpc(x, w, boards_per_cta=bpc))
        kernels[f"conv3x3_bpc[{bpc}]"] = dict(
            max_abs_err=abs_err, ms=ms, plain_ms=conv_plain_ms, library_ms=conv_library_ms,
            **bound({"bf16": 2.0 * 81 * b * 9 * c * c}, 2.0 * (2 * 81 * b * c + 9 * c * c)))
    del x, w, x_cl, w_cl, got, ref
    qb, qc, bt = qparts.B, qparts.CH, qparts.BT
    part_plain, timed_errs = {}, {}
    for v in qparts.VARIANTS:
        args = qparts.part_inputs(v, qb, qc, dev, seed=1)
        ref = qparts.qblock_part_reference(v, *args, batch_tile=bt)
        timed_errs[v] = qparts.compare_to_plain(v, qparts.qblock_part(v, *args, batch_tile=bt),
                                                ref)
        part_plain[v] = cuda_ms(lambda: qparts.qblock_part_reference(v, *args, batch_tile=bt),
                                iters=2, warmup=1)
        del args, ref
    full_args = qparts.full_block_args(qb, qc, bt, dev)
    full = int8_block_diff(quantized_gpbias_block(*full_args, batch_tile=bt),
                           quantized_gpbias_block_reference(*full_args, batch_tile=bt), bt)
    if not int8_block_ok(full):
        raise AssertionError(f"int8 block B={qb} disagrees with its plain version: {full}")
    timed_errs["full"] = {"max_abs_err": full["abs"], **full}
    part_plain["full"] = cuda_ms(lambda: quantized_gpbias_block_reference(*full_args,
                                                                          batch_tile=bt),
                                 iters=2, warmup=1)
    del full_args
    dot_plain = {}
    for dtype, key, name in ((torch.int8, "int8", "dotrate"),
                             (torch.bfloat16, "bf16", "dotrate16")):
        xd, wd = qparts.dot_inputs(dtype, qparts.DOT_M, dev, seed=1)
        ref = qparts.dot_chain_reference(xd, wd, qparts.DOT_CHAIN)
        timed_errs[name] = qparts.compare_to_plain(
            name, qparts.dot_chain(xd, wd, qparts.DOT_CHAIN), ref)
        dot_plain[key] = cuda_ms(lambda: qparts.dot_chain_reference(xd, wd, qparts.DOT_CHAIN),
                                 iters=2, warmup=1)
    print(f"phase7 check qblock_part/dot_chain B={qb} C={qc} bt={bt} "
          f"M={qparts.DOT_M} chain={qparts.DOT_CHAIN} {timed_errs}")
    mm_plain, mm_errs = {}, {}
    for dtype, key in ((torch.int8, "int8"), (torch.bfloat16, "bf16")):
        a, bmat = alt.mm_inputs(dtype, alt.GM, alt.GK, alt.GN, dev, seed=1)
        mm_errs[key] = alt.compare_mm(alt.tiled_mm(a, bmat), alt.tiled_mm_reference(a, bmat))
        mm_plain[key] = cuda_ms(lambda: alt.tiled_mm_reference(a, bmat), iters=3)
    print(f"phase7 check tiled_mm {alt.GM}x{alt.GK}x{alt.GN} max_abs_err {mm_errs}")
    del a, bmat
    sx = torch.randn(9, 9, dbg.B, dbg.C, generator=g, device=dev).to(torch.bfloat16)
    sw = torch.randn(3, 3, dbg.C, dbg.C, generator=g, device=dev).to(torch.bfloat16)
    stage_library_ms = cuda_ms(lambda: F.conv2d(
        sx.float().permute(2, 3, 0, 1), sw.float().permute(3, 2, 0, 1), padding=1))
    del sx, sw

    # -- the probes' entry points at their own sizes, counters from 0 -------
    counters = (fused_block_stage.launches, conv3x3_bpc.launches, qparts.qblock_part.launches,
                qparts.dot_chain.launches, alt.tiled_mm.launches)
    for counter in (*counters, conv3x3_hwbc.route_launches):
        counter.clear()
    quantized_gpbias_block.launches = 0  # qblock_part[full]: block calls, 3 kernels each
    t0 = time.monotonic()
    stages = dbg.run(dev, dbg.B, dbg.C, time_it=True)
    chains = direct.measure(dev)
    parts = qparts.measure(dev, qb, bt)
    mm = alt.measure(dev)
    if fused.main([str(SMOKE_GAMES)]) != 0:
        raise AssertionError("profile_fused_forward failed")
    torch.cuda.synchronize()
    launches = {**{f"fused_block_stage[{k}]": fused_block_stage.launches[k] for k in STAGES},
                **{f"conv3x3_bpc[{k}]": conv3x3_bpc.launches[k] for k in BOARDS_PER_CTA},
                "conv3x3_hwbc[256]": conv3x3_hwbc.route_launches["wgmma"],
                "conv3x3_hwbc": conv3x3_hwbc.route_launches["wgmma_padded"],
                "qblock_part[full]": quantized_gpbias_block.launches,
                **{f"qblock_part[{k}]": qparts.qblock_part.launches[k] for k in qparts.VARIANTS},
                **{f"dot_chain[{k}]": qparts.dot_chain.launches[k] for k in ("int8", "bf16")},
                **{f"tiled_mm[{k}]": alt.tiled_mm.launches[k] for k in ("int8", "bf16")}}
    print(f"phase7 probes driven in {time.monotonic() - t0:.1f} s; launches {launches}")
    if not all(launches.values()):
        raise AssertionError(f"a probe kernel was not launched by its entry point: {launches}")

    # -- what the scripts measured -------------------------------------------
    sb, sc, gpc = dbg.B, dbg.C, dbg.GPC
    conv_ops = 2.0 * 81 * sb * 9 * sc * sc
    fc = 2.0 * sb * (3 * sc * gpc + gpc * sc)
    fc_b = 2.0 * (3 * sc * gpc + gpc * sc) + 4.0 * (gpc + sc)
    io = 81.0 * sb * sc * (2 + 4) + 4.0 * 4 * sc
    w_b = 9.0 * sc * sc * 2
    stage_work = {"conv1": (conv_ops, io + w_b), "bnrelu": (conv_ops, io + w_b),
                  "pool": (0.0, io), "gpbias": (conv_ops + fc, io + w_b + fc_b),
                  "conv2": (2 * conv_ops + fc, io + 2 * w_b + fc_b)}
    for stage, r in stages.items():
        ops, nbytes = stage_work[stage]
        print(f"phase7 fused_block_stage[{stage}] B={sb} C={sc} ms={r['ms']:.4f} "
              f"plain_ms={r['plain_ms']:.4f}")
        kernels[f"fused_block_stage[{stage}]"] = dict(
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            library_ms=stage_library_ms if stage == "conv1" else None,
            **bound({"bf16": ops}, nbytes))
    flop = chains["flop"]
    print(f"phase7 direct conv chain x{direct.BLOCKS} B={direct.B} C={direct.C}: cudnn "
          f"{chains['cudnn']:.3f} ms ({flop / chains['cudnn'] / 1e9:.1f} TFLOP/s); "
          + "; ".join(f"{'bpc=' if k != 'hwbc' else 'conv3x3_'}{k} {chains[k]:.3f} ms "
                      f"({flop / chains[k] / 1e9:.1f} TFLOP/s, "
                      f"cudnn/this {chains['cudnn'] / chains[k]:.3f})"
                      for k in (*BOARDS_PER_CTA, "hwbc")))
    for bpc in BOARDS_PER_CTA:
        ms = kernels[f"conv3x3_bpc[{bpc}]"]["ms"]
        print(f"phase7 conv3x3_bpc[{bpc}] B={b} C={c} ms={ms:.4f} plain_ms={conv_plain_ms:.4f} "
              f"cudnn_ms={conv_library_ms:.4f}")
    cv, act, wq = 2.0 * 81 * qb * 9 * qc * qc, 81.0 * qb * qc, 9.0 * qc * qc
    part_work = {"convs": ({"int8": 2 * cv}, 2 * act + 2 * wq),
                 "novpu": ({"int8": 2 * cv}, 2 * act + 2 * wq),
                 "gemmonly": ({"int8": 2 * cv}, 3 * act + 2 * wq),
                 "vpuonly": ({}, 2 * act),
                 "bf16gemm": ({"bf16": 2 * cv}, 2 * (2 * act + 2 * wq)),
                 "full": ({"int8": 2 * cv, "bf16": fc_ops(qb, qc, 64, 16)},
                          2 * act + 2 * wq + fc_bytes(qc, 64, 16) + 8.0 * (qb // bt))}
    for v, r in parts.items():
        if v.startswith("dotrate"):
            key = "int8" if v == "dotrate" else "bf16"
            size = 1 if key == "int8" else 2
            m, k = qparts.DOT_M, qparts.DOT_K
            print(f"phase7 dot_chain[{key}] M={m} K=N={k} chain={qparts.DOT_CHAIN} "
                  f"ctas={r['ctas']} w_l2_mb={r['w_l2_bytes'] / 1e6:.1f} ms={r['ms']:.4f} "
                  f"rate={r['rate'] / 1e12:.1f}T plain_ms={dot_plain[key]:.3f} "
                  f"cublas_chain_ms={r['cublas_ms']:.4f}")
            kernels[f"dot_chain[{key}]"] = dict(
                max_abs_err=timed_errs[v]["max_abs_err"], ms=r["ms"], plain_ms=dot_plain[key],
                library_ms=None,
                **bound({key: r["ops"]}, size * (2.0 * m * k + k * k)))
            continue
        ops, nbytes = part_work[v]
        extra = " ".join(f"{n}_ms={t:.4f}" for n, t in r.get("kernels", {}).items())
        print(f"phase7 qblock_part[{v}] B={qb} C={qc} bt={bt} ms={r['ms']:.4f} "
              f"rate={r['rate'] / 1e12:.1f}T plain_ms={part_plain[v]:.3f} {extra}")
        kernels[f"qblock_part[{v}]"] = dict(
            max_abs_err=timed_errs[v]["max_abs_err"], ms=r["ms"], plain_ms=part_plain[v],
            library_ms=None, **bound(ops, nbytes))
    for key, size, out in (("int8", 1, 4), ("bf16", 2, 4)):
        ms, lms = mm[f"mm_{key}_ms"], mm[f"mm_{key}_library_ms"]
        print(f"phase7 tiled_mm[{key}] {alt.GM}x{alt.GK}x{alt.GN} ctas={mm['mm_ctas']} "
              f"ms={ms:.4f} ({mm['mm_ops'] / ms / 1e9:.1f}T) library_ms={lms:.4f} "
              f"plain_ms={mm_plain[key]:.4f}")
        kernels[f"tiled_mm[{key}]"] = dict(
            max_abs_err=mm_errs[key], ms=ms, plain_ms=mm_plain[key], library_ms=lms,
            **bound({key: mm["mm_ops"]},
                    size * (alt.GM + alt.GN) * alt.GK + out * alt.GM * alt.GN))
    print(f"phase7 direct (cuDNN) chain x{alt.BLOCKS} B={alt.B} {mm['direct_ms']:.3f} ms; "
          f"winograd torch ops {mm['winograd_ms']:.3f} ms")
    return kernels, launches


def league_phase(dev, card_line: str) -> None:
    """configs/katago-league.toml at full width through SelfPlayTrainer: 3
    epochs on the compact path (N=64, T=16, K=4) with maintenance after
    each, drained at the end; 1 epoch of the dynamic fallback (K=3) at a
    smaller depth; the VecEnv shim for 200 random legal steps. The cuts
    are printed; scripts/league_smoke.py raises if a check fails. No
    kernel lies on this path: league forwards are the eager model, as the
    reference's are XLA's."""
    from keisei_tpu_torch.scripts import league_smoke

    t0 = time.monotonic()
    runs = {}
    for label, kw in (("phase8 league", dict(epochs=3, games=64, steps=16, opponents=4)),
                      ("phase8 league_dynamic", dict(epochs=1, games=48, steps=16, opponents=3,
                                                     blocks=8))):
        torch.cuda.reset_peak_memory_stats()
        with tempfile.TemporaryDirectory() as tmp:
            runs[label] = league_smoke.run_league(dev, tmp, label=label, **kw)
    vec = league_smoke.drive_vec_env(dev)
    print(f"phase8 vec_env N=64 steps=200 steps_per_s={vec['steps_per_s']:.1f} "
          f"episodes={vec['episodes']} sfen[0]={vec['sfen']}")
    r = runs["phase8 league"]
    summary = {
        "card": card_line, "path": r["path"], "N": 64, "T": 16, "K": 4,
        "rollout_s": [round(m["rollout_time"], 4) for m in r["metrics"]],
        "update_s": [round(m["update_time"], 4) for m in r["metrics"]],
        "env_steps_per_s": [round(64 * 16 / m["rollout_time"], 1) for m in r["metrics"]],
        "maintenance_s": {k: round(v, 3) for k, v in r["maintenance_s"].items()},
        "pool": r["counts"], "peak_mem_gb": round(r["peak_mem_gb"], 2),
        "dynamic_K3_b8": {k: round(runs["phase8 league_dynamic"]["metrics"][0][k], 4)
                          for k in ("rollout_time", "update_time")},
        "vec_env_steps_per_s": round(vec["steps_per_s"], 1),
        "phase_s": round(time.monotonic() - t0, 1)}
    print(f"phase8 league {json.dumps(summary)}")


def tournament_phase(dev, card_line: str) -> None:
    """The league tournament on the card (scripts/tournament_smoke.py): one
    in-process round of configs/katago-league.toml's league at full width
    (b40c256, bf16 snapshots, parallel_matches 4 x envs_per_match 16) on a
    store of random-weight entries (2 Dynamic training, 1 Recent, 1
    Frontier) with a Dynamic update after every match; the sidecar mode
    (dispatcher, then one worker batch); the wiring (league epochs of
    SelfPlayTrainer at 8 blocks, N=48, K=3, with a round due). The cuts
    are printed; the script raises if a check fails. No kernel lies on this
    path: the pool's stacked forward and the Dynamic update are eager
    torch, as the reference's are XLA's."""
    from keisei_tpu_torch.scripts import league_smoke, tournament_smoke

    t0 = time.monotonic()
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.reset_peak_memory_stats()
        r = tournament_smoke.run_round(dev, os.path.join(tmp, "round"), max_ply=64,
                                       chunk_steps=64, label="phase9 round")
        round_peak = torch.cuda.max_memory_allocated() / 1e9
        s = tournament_smoke.run_sidecar(dev, os.path.join(tmp, "sidecar"), max_ply=64,
                                         label="phase9 sidecar")
        os.makedirs(os.path.join(tmp, "wiring"))
        w = league_smoke.run_league(dev, os.path.join(tmp, "wiring"), epochs=2, games=48,
                                    steps=16, opponents=3, max_ply=64, blocks=8,
                                    label="phase9 wiring",
                                    tournament={"min_epoch": 1, "max_ply": 64,
                                                "chunk_steps": 64})
    st = r["stats"]
    ok = [u for u in r["updates"] if u["ok"]]
    summary = {
        "card": card_line, "P": r["P"], "E": r["E"], "max_ply": 64, "chunk_steps": 64,
        "round_s": round(r["wall_s"], 3), "phase_s": st["phase_s"],
        "games": st["total_games"], "plies": st["total_plies"],
        "games_per_min": round(st["games_per_min"], 1),
        "pairings": [st["pairings_completed"], st["pairings_requested"]],
        "dynamic_updates": len(ok), "dynamic_update_s": [round(u["s"], 3) for u in ok],
        "dynamic_update_peak_gb": [round(u["peak_gb"], 2) for u in ok],
        "round_peak_gb": round(round_peak, 2),
        "ply_ms": {k: round(v, 3) for k, v in r["ply_ms"].items()},
        "worker_s_per_pairing": round(s["s_per_pairing"], 3),
        "wiring_round": w["counts"].get("tournament"),
        "wiring_maintenance_s": {k: round(v, 3) for k, v in w["maintenance_s"].items()},
        "phase9_s": round(time.monotonic() - t0, 1)}
    print(f"phase9 tournament {json.dumps(summary)}")


def sl_phase(dev, card_line: str) -> None:
    """The supervised warm start on the card (scripts/sl_smoke.py) at the
    width of configs/katago-b40c256.toml: 256 games on 256 envs (max_ply
    320) written as CSA, prepare_sl_data with the encoder on the card (8
    games re-encoded on the CPU to the same bits), 100 SL steps at B=256
    and 10 at B=1024, evaluate on a held-out split, sl_to_rl (N=64, T=16,
    sl_epochs 1 at B=256) over an RL epoch_000002 in the same directory,
    and two RL epochs with asynchronous saves every epoch, each reloaded;
    then 3 SL steps at 4,096 rows, sl_to_rl's default batch, which recompute
    each block in the backward (sl/trainer.py:RECOMPUTE_ABOVE), with their
    peak memory and seconds. The cuts are printed; the script raises if a
    check fails. No kernel lies on this path: the reference's SL step is
    flax + XLA, its encoder the engine."""
    from keisei_tpu_torch.scripts import sl_smoke

    t0 = time.monotonic()
    with tempfile.TemporaryDirectory() as tmp:
        r = sl_smoke.run_sl(dev, tmp, label="phase10 sl")
    tr, big, ev = r["train"], r["train_big"], r["eval"]
    summary = {
        "card": card_line, "corpus_games_per_s": round(r["corpus"]["games_per_s"], 3),
        "corpus_games": r["corpus"]["games"], "positions": r["prepare"]["positions"],
        "encode_positions_per_s": round(r["prepare"]["positions_per_s"], 1),
        "sl": {str(x["batch"]): {"steps": x["steps"], "steps_per_s": round(x["steps_per_s"], 3),
                                 "positions_per_s": round(x["positions_per_s"], 1),
                                 "peak_gb": round(x["peak_gb"], 2)} for x in (tr, big)},
        "eval": {k: round(ev[k], 4) for k in ("policy_top1", "policy_top5", "policy_nll",
                                              "value_acc", "score_mse")},
        "sl_4096": {k: r["probe"][k] for k in ("recomputes", "peak_gb", "step_s")},
        "sl_to_rl_s": round(r["transition"]["sl_to_rl_s"], 2),
        "rl_epochs": [{k: round(v, 4) for k, v in e.items()} for e in r["transition"]["rl_epochs"]],
        "blocking_save_s": round(r["transition"]["blocking_save_s"], 4),
        "phase10_s": round(time.monotonic() - t0, 1)}
    print(f"phase10 sl {json.dumps(summary)}")


def feed_phase(dev, card_line: str) -> None:
    """The dashboard feed on the card (scripts/showcase_smoke.py): the
    spectator env on the card against the CPU's over a random legal game of
    up to 256 plies and a decided SFEN; an exhibition game of two b40c256
    entries at full width (random weights) through ShowcaseRunner.run with
    the move delays at 0 (max_ply 512, cut to 256 and printed where the
    measured forward and step put it past 60 s), timed per ply; a
    demonstrator game of max_ply 64; the dashboard server's messages
    validated and a queue command over the WebSocket. The script raises if
    a check fails. No kernel lies on this path: the reference's showcase
    runs the flax model at B=1, its spectator the engine."""
    from keisei_tpu_torch.scripts import showcase_smoke

    t0 = time.monotonic()
    with tempfile.TemporaryDirectory() as tmp:
        r = showcase_smoke.run_feed(dev, tmp, label="phase11 feed")
    sh = r["showcase"]
    summary = {
        "card": card_line, "spectator_plies": r["spectator"]["plies"],
        "spectator_step_ms": round(r["spectator"]["step_ms"], 3),
        "showcase": {k: (round(v, 3) if isinstance(v, float) else v) for k, v in sh.items()
                     if k != "value_range"},
        "demo_plies": r["demo"]["plies"], "server_messages": r["server"]["messages"],
        "phase11_s": round(time.monotonic() - t0, 1)}
    print(f"phase11 feed {json.dumps(summary)}")


def parallel_phase(dev, card_line: str) -> None:
    """Data parallelism on the one card (scripts/parallel_smoke.py): (a) two
    ranks sharing it over gloo, 2 league epochs of
    configs/katago-league-multihost.toml and 2 self-play epochs of
    configs/katago-b40c256.toml at full width, cut in scale (64 global
    games, 16 plies, batch 256), held bit-identical across ranks after each
    epoch, with global counts, rank 1 writing nothing, the summed gradient
    against one process's and the W=2 checkpoint resumed at W=1; (b) a
    self-play epoch with its collectives on NCCL at world size 1, the
    gradient bucket's all-reduce timed; (c) scripts/dryrun_multichip.py at
    two ranks over gloo. The script raises if a check fails. No kernel lies
    on this path: the JAX package refuses its Pallas forwards under a mesh
    (keisei_tpu/training/loop.py:519-540), and one card measures no
    multi-card speed."""
    from keisei_tpu_torch.scripts import parallel_smoke

    t0 = time.monotonic()
    with tempfile.TemporaryDirectory() as tmp:
        r = parallel_smoke.run_parallel(dev, tmp, label="phase12")
    per_rank = {}
    for row in r["a"]["rows"]:
        per_rank.setdefault(row["rank"], []).append(
            {k: round(row[k], 3) for k in ("rollout_s", "update_s", "peak_gb")})
    b = r["b"]
    summary = {
        "card": card_line, "a_s": round(r["a"]["seconds"], 1), "per_rank_epochs": per_rank,
        "grad": {name: {k: round(v, 6) for k, v in g.items()}
                 for name, g in r["a"]["grad"].items()},
        "b": {"backend": b["backend"], "bucket_mb": round(b["bucket_mb"], 1),
              "bucket_all_reduce_ms": round(b["bucket_ms"], 3), "minibatches": b["minibatches"],
              "collectives_per_epoch": b["collectives"],
              "all_reduce_per_minibatch": b["all_reduce_per_minibatch"],
              "update_s": round(b["update_s"], 3)},
        "c_s": round(r["c"]["seconds"], 1), "phase12_s": round(time.monotonic() - t0, 1)}
    print(f"phase12 parallel {json.dumps(summary)}")


def train_path_phase(dev, card_line: str) -> dict:
    """The train path's kernels (ops/train_bn.py) against their plain
    versions over a grid of shapes in f32 and bf16, then each timed at the
    main path's shape (B=1,024, C=256, bf16) beside its bound, its plain
    version and cuDNN's F.batch_norm; a block's and the b40c256 model's
    train step on them and on the plain path."""
    from keisei_tpu_torch.scripts import profile_train_bn as ptb

    t0 = time.monotonic()
    # the edges (B=1, 65 rows, C=32), the phase-5 update's minibatch (256 rows;
    # C=256, and C=32 at policy_bn1) and the training cells' (1,024 rows)
    for dtype in (torch.float32, torch.bfloat16):
        for b, c in ((1, 32), (65, 128), (256, 32), (256, 256), (1024, 128), (1024, 256)):
            errs = ptb.check(b, c, dtype, dev)
            print(f"phase13 check {dtype} B={b} C={c} "
                  f"worst_rel_err={max(max(v) for v in errs.values()):.3g}")
    rows = ptb.measure(dev)
    kernels = {}
    for name, r in rows.items():
        print(f"phase13 {card_line} {name} B=1024 C=256 bf16 ms={r['ms']:.4f} "
              f"bound_ms={r['bound_ms']:.4f} plain_ms={r['plain_ms']:.4f} "
              f"library_ms={r['library_ms']} rel_err={r['max_rel_err']:.3g}")
        kernels[name] = dict(max_rel_err=r["max_rel_err"], ms=r["ms"], plain_ms=r["plain_ms"],
                             library_ms=r["library_ms"], bound_ms=r["bound_ms"],
                             bound_by=r["bound_by"])
    steps = ptb.steps(dev)
    print(f"phase13 steps {card_line} {json.dumps(steps)} "
          f"phase13_s={time.monotonic() - t0:.1f}")
    return kernels


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
    from keisei_tpu_torch.ops.conv3x3 import (WGMMA_BOARDS, conv3x3_hwbc, conv3x3_hwbc_reference,
                                              conv_route, pad_channels)
    from keisei_tpu_torch.ops.fused_block import (block_plan, fused_gpbias_block,
                                                  fused_gpbias_block_reference)
    from keisei_tpu_torch.ops.gemm_chain import PLANS, hold_to_plain
    from keisei_tpu_torch.ops.qblock import (pack_quantized, qblock_plan, quantized_gpbias_block,
                                             quantized_gpbias_block_reference)
    from keisei_tpu_torch.scripts import profile_direct_conv as direct
    from keisei_tpu_torch.scripts import profile_fused_forward as fused
    from keisei_tpu_torch.scripts import profile_int8_mma as probe
    from keisei_tpu_torch.scripts import profile_qblock_parts as qparts
    from keisei_tpu_torch.scripts import profile_train_bn as ptb
    from keisei_tpu_torch.training.checkpoint import load_checkpoint
    from keisei_tpu_torch.training.config import load_config
    from keisei_tpu_torch.training.loop import SelfPlayTrainer
    from keisei_tpu_torch.training.ppo import make_optimizer
    from keisei_tpu_torch.utils.timing import card, cuda_ms, graph_ms

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
    # the chain kernels' SASS, one kernel a (type, K): wgmma fed by TMA, no
    # mma.sync, no local memory
    sass = _build.sass_counts(r"gemm_chain_kernel")
    for name, counts in sass.items():
        print(f"phase2 sass {name} {counts}")
    if len(sass) != len(PLANS) or not all(
            c["wgmma"] and c["tma_load"] and not c["mma_sync"] and not c["local"]
            for c in sass.values()):
        raise AssertionError(f"the chain kernels' SASS is not wgmma + TMA without spills: {sass}")

    # -- phase 3: kernels vs plain versions on the card ----------------------
    g = torch.Generator(device=dev).manual_seed(0)
    kernels = {}
    gpc, sec = 128, 16  # b40c256: global_pool_channels 128, se_reduction 16

    def check_conv(b: int, cin: int, gen: torch.Generator) -> None:
        """conv3x3_hwbc at (b, cin -> 256) against its plain version, on the
        route its shapes name; its time, the plain version's and cuDNN's. For
        the 50 planes also the forward's call on planes padded beforehand,
        which must give the same bits, and the mma.sync kernel's time."""
        x = torch.randn(9, 9, b, cin, generator=gen, device=dev).to(torch.bfloat16)
        w = (torch.randn(3, 3, cin, 256, generator=gen, device=dev)
             / math.sqrt(9 * cin)).to(torch.bfloat16)
        conv3x3_hwbc.route_launches.clear()
        got = conv3x3_hwbc(x, w)
        ref = conv3x3_hwbc_reference(x, w)
        torch.cuda.synchronize()
        route = conv_route(b, cin, 256)
        if dict(conv3x3_hwbc.route_launches) != {"wgmma" if cin % 64 == 0 else "wgmma_padded": 1}:
            raise AssertionError(f"conv3x3 Cin={cin} took the wrong kernel: "
                                 f"{dict(conv3x3_hwbc.route_launches)}")
        abs_err, rel_err = max_errors(got, ref)
        ok = torch.allclose(got.float(), ref.float(), rtol=TOL, atol=TOL)
        plain_ms = cuda_ms(lambda: conv3x3_hwbc_reference(x, w), iters=5)
        work = bound({"bf16": 2.0 * 81 * b * 9 * cin * 256},
                     2.0 * (81 * b * cin + 9 * cin * 256 + 81 * b * 256))
        name = "conv3x3_hwbc[256]"
        if cin % 64 == 0:
            # replayed from a CUDA graph: these kernels run for less time than
            # Python takes to launch them
            ms = graph_ms(lambda: conv3x3_hwbc(x, w))
            # the library yardstick: cuDNN's bf16 conv, channels_last, same shapes
            x_cl, w_cl = direct.cudnn_x(x), direct.cudnn_w(w)
            library_ms = graph_ms(lambda: F.conv2d(x_cl, w_cl, padding=1))
            extra = ""
        else:
            name = "conv3x3_hwbc"
            xp, wp = pad_channels(x, 3), pad_channels(w, 2)
            conv3x3_hwbc.route_launches.clear()
            gotp = conv3x3_hwbc(xp, wp)
            torch.cuda.synchronize()
            if dict(conv3x3_hwbc.route_launches) != {"wgmma": 1} or not torch.equal(gotp, got):
                raise AssertionError(f"conv3x3 Cin={cin}: the call on padded planes differs from "
                                     f"the padding route ({dict(conv3x3_hwbc.route_launches)})")
            t = fused.stem_conv_ms(x, w)
            ms, library_ms = t["hwbc"], t["cudnn"]
            extra = (f" padded_ms={t['padded']:.4f} mma_sync_ms={t['mma_sync']:.4f} "
                     f"cudnn_padded_ms={t['cudnn_padded']:.4f} fill_ms={t['fill']:.4f} "
                     f"cast_ms={t['cast']:.4f}")
            if b == SMOKE_GAMES:
                # the fused forward's own call, planes padded beforehand. Its work is
                # the 50-plane conv's (`work`): the 14 zero channels are the design's
                # cost. `ms` is the kernel alone; the forward also pays fill_ms for
                # its padded planes where unpadded ones would take cast_ms.
                kernels[PADDED_STEM] = dict(
                    max_abs_err=max_errors(gotp, conv3x3_hwbc_reference(xp, wp))[0],
                    ms=t["padded"],
                    plain_ms=cuda_ms(lambda: conv3x3_hwbc_reference(xp, wp), iters=5),
                    library_ms=t["cudnn_padded"], fill_ms=t["fill"], cast_ms=t["cast"], **work)
        print(f"phase3 conv3x3 B={b} Cin={cin} Cout=256 kernel={route.kernel} "
              f"tile={route.boards}x{route.cout_tile} max_abs_err={abs_err:.4g} "
              f"max_rel_err={rel_err:.4g} tol={TOL} ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"library_ms={library_ms:.4f} bound_ms={work['bound_ms']:.4f}{extra}")
        if not ok:
            raise AssertionError(f"conv3x3 B={b} Cin={cin} disagrees with its plain version")
        if b == SMOKE_GAMES:  # Cin 50: the observation planes; 256: a trunk conv
            kernels[name] = dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                                 library_ms=library_ms, **work)

    def block_work(b: int) -> dict:
        return bound({"bf16": 2 * 2.0 * 81 * b * 9 * 256 * 256 + fc_ops(b, 256, gpc, sec)},
                     2 * 2.0 * 81 * b * 256 + 2 * 2.0 * 9 * 256 * 256 + fc_bytes(256, gpc, sec))

    def time_block(b: int, x: torch.Tensor, blocks: list, err: tuple[float, float]) -> None:
        """The block's time over 40 weight sets (one CUDA graph of the 40
        calls), its four kernels' from a trace, the plain version's."""
        ms = fused.block_ms(x, blocks)
        parts, traced = fused.block_kernels_ms(x, blocks)
        plain_ms = cuda_ms(lambda: fused.trunk(fused_gpbias_block_reference, x, blocks), iters=2,
                           warmup=1) / 40
        work = block_work(b)
        print(f"phase3 fused_gpbias_block B={b} C=256 weight_sets=40 max_abs_err={err[0]:.4g} "
              f"max_rel_err={err[1]:.4g} tol={TOL} ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"bound_ms={work['bound_ms']:.4f} "
              + " ".join(f"{k}_ms={v:.4f}" for k, v in parts.items())
              + f" traced_launches={traced}")
        if b == SMOKE_GAMES:
            kernels["fused_gpbias_block"] = dict(max_abs_err=err[0], ms=ms, plain_ms=plain_ms,
                                                 library_ms=None, kernels_ms=parts,
                                                 traced_launches=traced, **work)

    def check_int8_trunk(b: int, x: torch.Tensor, blocks: list) -> None:
        """The int8 block over the same 40 weight sets, quantized as the int8
        forward's prepare does, each held to its plain version at the
        card-test bound (outputs at most 1 level apart, >= 99% identical,
        scales within rtol 1e-4); its time over the 40 (one CUDA graph of the
        40-call trunk), its six kernels' from a trace, the plain version's."""
        qblocks = [qparts.int8_weights(*wts) for wts in blocks]
        xq, sx = pack_quantized(x.float(), 32)
        diffs = [int8_block_diff(quantized_gpbias_block(xq, sx, *wts, batch_tile=32),
                                 quantized_gpbias_block_reference(xq, sx, *wts, batch_tile=32), 32)
                 for wts in qblocks]
        worst = {"levels": max(d["levels"] for d in diffs),
                 "identical": min(d["identical"] for d in diffs),
                 "scale_rel": max(d["scale_rel"] for d in diffs),
                 "abs": max(d["abs"] for d in diffs)}
        if not int8_block_ok(worst):
            raise AssertionError(f"int8 block B={b} disagrees with its plain version: {worst}")
        ms = qparts.block_ms(xq, sx, qblocks)
        parts, traced = qparts.block_kernels_ms(xq, sx, qblocks)
        plain_ms = cuda_ms(lambda: qparts.trunk(quantized_gpbias_block_reference, xq, sx, qblocks),
                           iters=2, warmup=1) / 40
        work = bound({"int8": 2 * 2.0 * 81 * b * 9 * 256 * 256, "bf16": fc_ops(b, 256, gpc, sec)},
                     2.0 * 81 * b * 256 + 2 * 9.0 * 256 * 256 + fc_bytes(256, gpc, sec)
                     + 4.0 * 2 * (b // 32))
        print(f"phase3 quantized_gpbias_block B={b} C=256 bt=32 weight_sets=40 "
              f"max_level_diff={worst['levels']} min_identical={worst['identical']:.5f} "
              f"max_scale_rel_err={worst['scale_rel']:.3g} max_abs_err={worst['abs']:.4g} "
              f"ms={ms:.4f} plain_ms={plain_ms:.4f} bound_ms={work['bound_ms']:.4f} "
              + " ".join(f"{k}_ms={v:.4f}" for k, v in parts.items())
              + f" traced_launches={traced}")
        if b == SMOKE_GAMES:
            kernels["quantized_gpbias_block"] = dict(
                max_abs_err=worst["abs"], ms=ms, plain_ms=plain_ms, library_ms=None,
                kernels_ms=parts, traced_launches=traced, **work)

    for b in (64, 256):
        for cin in (50, 256):
            check_conv(b, cin, g)
        # 40 distinct weight sets, as in one b40c256 trunk: weights stream from HBM
        blocks = [fused.block_weights(256, gpc, sec, g, dev) for _ in range(40)]
        x = torch.relu(torch.randn(9, 9, b, 256, generator=g, device=dev)).to(torch.bfloat16)
        got = fused_gpbias_block(x, *blocks[0])
        ref = fused_gpbias_block_reference(x, *blocks[0])
        torch.cuda.synchronize()
        abs_err, rel_err = max_errors(got, ref)
        ok = torch.allclose(got.float(), ref.float(), rtol=TOL, atol=TOL)

        if not ok:
            raise AssertionError(f"fused block B={b} disagrees with its plain version")
        time_block(b, x, blocks, (abs_err, rel_err))

        check_int8_trunk(b, x, blocks)
        del blocks

    # the block over partial tiles of both heights and both widths, each twice
    # with equal bits (fixed summation order, no atomics), once replayed from a
    # CUDA graph on new values, and timed at the largest rollout batch; a
    # generator of its own keeps the streams above as they were
    g3 = torch.Generator(device=dev).manual_seed(5)
    for c in (128, 256):
        wts = fused.block_weights(c, c // 2, c // 16, g3, dev)
        for b in (1, 31, 64, 65, 256, 1024):
            x = torch.relu(torch.randn(9, 9, b, c, generator=g3, device=dev)).to(torch.bfloat16)
            got, again = fused_gpbias_block(x, *wts), fused_gpbias_block(x, *wts)
            ref = fused_gpbias_block_reference(x, *wts)
            torch.cuda.synchronize()
            abs_err = max_errors(got, ref)[0]
            plan = block_plan(b, c)
            print(f"phase3 fused_gpbias_block B={b} C={c} tile={plan.tile.boards}x{c} "
                  f"pool_boards={plan.pool_boards} max_abs_err={abs_err:.4g} "
                  f"repeat_equal={torch.equal(got, again)}")
            if not torch.equal(got, again):
                raise AssertionError(f"fused block B={b} C={c}: two runs differ")
            if not torch.allclose(got.float(), ref.float(), rtol=TOL, atol=TOL):
                raise AssertionError(f"fused block B={b} C={c} disagrees with its plain version")
    x = torch.relu(torch.randn(9, 9, 65, 256, generator=g3, device=dev)).to(torch.bfloat16)
    wts = fused.block_weights(256, gpc, sec, g3, dev)
    fused_gpbias_block(x, *wts)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        out = fused_gpbias_block(x, *wts)
    x.copy_(torch.relu(torch.randn(9, 9, 65, 256, generator=g3, device=dev)))
    graph.replay()
    torch.cuda.synchronize()
    ref = fused_gpbias_block_reference(x, *wts)
    if not torch.allclose(out.float(), ref.float(), rtol=TOL, atol=TOL):
        raise AssertionError("fused block replayed from a CUDA graph on new values disagrees "
                             "with its plain version")
    print(f"phase3 fused_gpbias_block graph replay on new values B=65 C=256 "
          f"max_abs_err={max_errors(out, ref)[0]:.4g}")
    del graph, out
    blocks = [fused.block_weights(256, gpc, sec, g3, dev) for _ in range(40)]
    x = torch.relu(torch.randn(9, 9, 1024, 256, generator=g3, device=dev)).to(torch.bfloat16)
    time_block(1024, x, blocks, max_errors(fused_gpbias_block(x, *blocks[0]),
                                           fused_gpbias_block_reference(x, *blocks[0])))
    check_int8_trunk(1024, x, blocks)
    del blocks, x, wts

    # the int8 block over B in {32, 64, 96, 256, 1024} (96: a partial 64-board
    # tile) x C in {128, 256}, each twice with equal bits (the tile maxima are
    # atomicMax on f32 bits, which does not depend on order), and once from a
    # CUDA graph on new values (the maxima zeroed inside the replay); a
    # generator of its own keeps the streams above as they were
    g5 = torch.Generator(device=dev).manual_seed(6)

    def int8_inputs(b: int, c: int) -> tuple:
        x = torch.relu(torch.randn(9, 9, b, c, generator=g5, device=dev))
        return (*pack_quantized(x, 32),
                *qparts.int8_weights(*fused.block_weights(c, c // 2, c // 16, g5, dev)))

    for c in (128, 256):
        for b in (32, 64, 96, 256, 1024):
            args = int8_inputs(b, c)
            got, again = (quantized_gpbias_block(*args, batch_tile=32) for _ in range(2))
            d = int8_block_diff(got, quantized_gpbias_block_reference(*args, batch_tile=32), 32)
            repeat = torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])
            tile = qblock_plan(b, c).tile.boards
            print(f"phase3 quantized_gpbias_block B={b} C={c} tile={tile}x{c} "
                  f"max_level_diff={d['levels']} identical={d['identical']:.5f} "
                  f"scale_rel_err={d['scale_rel']:.3g} repeat_equal={repeat}")
            if not (repeat and int8_block_ok(d)):
                raise AssertionError(f"int8 block B={b} C={c}: {d}, repeat_equal={repeat}")
    args = int8_inputs(96, 256)
    quantized_gpbias_block(*args, batch_tile=32)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        out = quantized_gpbias_block(*args, batch_tile=32)
    new = int8_inputs(96, 256)
    args[0].copy_(new[0])
    args[1].copy_(new[1])
    for replay in range(2):
        graph.replay()
        torch.cuda.synchronize()
        d = int8_block_diff(out, quantized_gpbias_block_reference(*args, batch_tile=32), 32)
        if not int8_block_ok(d):
            raise AssertionError(f"int8 block replayed from a CUDA graph on new values disagrees "
                                 f"with its plain version: {d}")
    print(f"phase3 quantized_gpbias_block graph replay (twice) on new values B=96 C=256 "
          f"max_level_diff={d['levels']} identical={d['identical']:.5f} "
          f"scale_rel_err={d['scale_rel']:.3g}")
    del graph, out, args, new

    # the trunk conv at the probes' batch, then the wgmma conv's tails and
    # every K depth, and one-hot boards whose every tap holds its own integers
    # (equal: a transposed tap or a wrong zero-filled edge would show as a
    # wrong square); a generator of their own keeps the streams above as they were
    g2 = torch.Generator(device=dev).manual_seed(4)
    for cin in (50, 256):
        check_conv(1024, cin, g2)
    shapes = [(b, cin, cout) for b in (1, 65) for cin in (64, 128) for cout in (128, 256)]
    for b, cin, cout in shapes + [(1, 256, 256), (65, 256, 256)]:
        x = torch.randn(9, 9, b, cin, generator=g2, device=dev).to(torch.bfloat16)
        w = (torch.randn(3, 3, cin, cout, generator=g2, device=dev)
             / math.sqrt(9 * cin)).to(torch.bfloat16)
        conv3x3_hwbc.route_launches.clear()
        got, ref = conv3x3_hwbc(x, w), conv3x3_hwbc_reference(x, w)
        torch.cuda.synchronize()
        abs_err = max_errors(got, ref)[0]
        if (conv3x3_hwbc.route_launches["wgmma"] != 1
                or not torch.allclose(got.float(), ref.float(), rtol=TOL, atol=TOL)):
            raise AssertionError(f"wgmma conv3x3 B={b} Cin={cin} Cout={cout} disagrees with its "
                                 f"plain version (max abs err {abs_err})")
        print(f"phase3 conv3x3 wgmma B={b} Cin={cin} Cout={cout} max_abs_err={abs_err:.4g}")
    for name, square in direct.ONE_HOT_SQUARES.items():
        for cin, cout in ((64, 128), (256, 256)):
            xh, wh = direct.one_hot_inputs(square, cin=cin, cout=cout)
            got = conv3x3_hwbc(xh.to(dev), wh.to(dev)).float().cpu()
            if not torch.equal(got, direct.one_hot_expected(square, wh, 5, 2, cin - 1)):
                raise AssertionError(f"wgmma conv3x3 lays the taps of a one-hot board at the "
                                     f"{name} wrongly (Cin={cin})")
    print(f"phase3 conv3x3 wgmma one-hot boards {list(direct.ONE_HOT_SQUARES)} equal")

    # the tensor-core rate probe against its plain version (int8 exact, bf16 at
    # TOL, 32 bf16 steps one by one: ops/gemm_chain.py:hold_to_plain): a
    # partial tile at K = 512, then the inputs phase 6 times
    probe_errs = probe.check(dev)
    probe_plain_ms = {}
    for dtype in probe.PEAK:
        key = "bf16" if dtype == torch.bfloat16 else "int8"
        a, bmat = probe.probe_inputs(dtype, probe.M, dev, seed=1)
        probe_errs[f"{key}_timed"] = hold_to_plain(probe.mma_chain, a, bmat, probe.CHAIN)
        probe_plain_ms[key] = cuda_ms(lambda: probe.mma_chain_reference(a, bmat, probe.CHAIN),
                                      iters=2, warmup=1)
        del a, bmat
    print(f"phase3 mma_chain K={probe.K} chain=3 and M={probe.M} chain={probe.CHAIN} "
          f"max_abs_err {probe_errs} plain_ms {probe_plain_ms}")

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
        conv3x3_hwbc.route_launches.clear()
        fused_gpbias_block.launches = 0
        with torch.no_grad():
            got = fwd(weights, obs)
            ref = model(obs)
            truth = f32_model(obs)
        per_forward = (fused_gpbias_block.launches, dict(conv3x3_hwbc.route_launches))
        if per_forward != (40, {"wgmma": 1}):
            raise AssertionError("one fused forward must launch 40 blocks and 1 conv on padded "
                                 f"planes, none on mma.sync: {per_forward}")
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
              f"top1_agree={agree:.3f} fused_forward_ms={fused_ms:.3f} eager_forward_ms={eager_ms:.3f} "
              f"block_launches={per_forward[0]} conv_route_launches={per_forward[1]}")
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
        quantized_gpbias_block.launches = 0
        q = qfwd(qweights, obs)
        torch.cuda.synchronize()
        if quantized_gpbias_block.launches != 40:
            raise AssertionError(f"one int8 forward must launch 40 int8 blocks: "
                                 f"{quantized_gpbias_block.launches}")
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
              f"fused_forward_ms={fused_ms:.3f} int8_block_launches=40")
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
            conv3x3_hwbc.route_launches.clear()
            fused_gpbias_block.launches = 0
            quantized_gpbias_block.launches = 0
            ptb.reset_launches()
            trainer.run(2)
            torch.cuda.synchronize()
            # every train kernel, each mode of the three that take one, launched
            # by the update; its BatchNorms (input_bn, policy_bn1, two a block)
            # all on the kernels
            train_counts = ptb.launch_counts()
            bn_calls = train_counts["bn_sums"]
            if bn_calls < 2 * (2 + 2 * config.model.params["num_blocks"]) \
                    or not all(train_counts.values()):
                raise AssertionError(f"the {mode} update left the train kernels: "
                                     f"{train_counts}")
            if dict(conv3x3_hwbc.route_launches) != {"wgmma": conv3x3_hwbc.launches}:
                raise AssertionError(f"the {mode} path's input conv left the wgmma kernel: "
                                     f"{dict(conv3x3_hwbc.route_launches)}")
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
                  f"{block}={counts[block]} {other}={counts[other]} min_forwards={forwards} "
                  f"train_kernels={json.dumps(train_counts)}")
            if counts[block] < 40 * forwards or counts["conv3x3_hwbc"] < forwards or counts[other]:
                raise AssertionError(f"the {mode} path did not go through its kernels: {counts}")
            if mode == "fused":
                launches.update({PADDED_STEM: counts["conv3x3_hwbc"],
                                 "fused_gpbias_block": counts[block], **train_counts})
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
    probe.mma_chain.launches.clear()
    res = probe.measure(dev)
    for key, size in (("int8", 1), ("bf16", 2)):
        r, name = res[key], f"mma_chain[{key}]"
        launches[name] = probe.mma_chain.launches[key]
        print(f"phase6 probe {card_line} {key} M={probe.M} K={probe.K} chain={probe.CHAIN} "
              f"cluster={r['cluster'].cn}x{r['cluster'].rows} ctas={r['ctas']} "
              f"max_clusters={r['max_clusters']} ms={r['ms']:.4f} "
              f"rate={r['rate'] / 1e12:.1f}T ({100 * r['peak_share']:.1f}% of "
              f"{probe.PEAK[torch.int8 if key == 'int8' else torch.bfloat16] / 1e12:.0f}) "
              f"plain_ms={probe_plain_ms[key]:.3f} launches={launches[name]}")
        if launches[name] < 1:
            raise AssertionError(f"the probe did not launch its {key} kernel")
        errs = probe_errs[f"{key}_timed"]
        # the whole chain's error; a bf16 chain of 32 is held step by step,
        # and step_err is its largest single step's (hold_to_plain)
        kernels[name] = dict(
            max_abs_err=errs["max_abs_err"], step_err=errs.get("step_err"), ms=r["ms"],
            plain_ms=probe_plain_ms[key],
            library_ms=None,
            **bound({key: r["ops"]}, size * (2.0 * probe.M * probe.K + probe.K * probe.K)))

    # -- phase 7: the probes (PERF.md rows 5-8) through their entry points ------
    probe_kernels, probe_launches = probe_phase(dev)
    kernels.update(probe_kernels)
    launches.update(probe_launches)

    # -- phase 8: league training on the card --------------------------------------
    league_phase(dev, card_line)

    # -- phase 9: the league tournament on the card ----------------------------------
    tournament_phase(dev, card_line)

    # -- phase 10: the supervised warm start on the card ---------------------------------
    sl_phase(dev, card_line)

    # -- phase 11: the dashboard feed on the card ------------------------------------------
    feed_phase(dev, card_line)

    # -- phase 12: data parallelism on the one card ----------------------------------------
    parallel_phase(dev, card_line)

    # -- phase 13: the train path's kernels (PERF.md's PR 19 rows) ----------------------------
    # (their launches are phase 5's fused update's, counted from 0)
    train_kernels = train_path_phase(dev, card_line)
    kernels.update(train_kernels)

    sources = {
        PADDED_STEM: ("keisei_tpu_torch/csrc/conv3x3_wgmma.cu", "keisei_tpu/ops/conv3x3.py:69"),
        "conv3x3_hwbc": ("keisei_tpu_torch/csrc/conv3x3_wgmma.cu", "keisei_tpu/ops/conv3x3.py:69"),
        "fused_gpbias_block": ("keisei_tpu_torch/csrc/fused_block.cu",
                               "keisei_tpu/ops/fused_block.py:124"),
        "quantized_gpbias_block": ("keisei_tpu_torch/csrc/qblock.cu",
                                   "keisei_tpu/ops/qblock.py:173"),
        **{f"mma_chain[{key}]": ("keisei_tpu_torch/csrc/chain_wgmma.cu",
                                  "scripts/profile_int8_mxu.py:71") for key in ("int8", "bf16")},
    }
    csrc = "keisei_tpu_torch/csrc/"
    sources["conv3x3_hwbc[256]"] = (csrc + "conv3x3_wgmma.cu", "keisei_tpu/ops/conv3x3.py:69")
    wgmma_heights = [f"conv3x3_bpc[{boards}]" for boards in WGMMA_BOARDS]
    for name in probe_kernels:
        family = name.split("[")[0]
        sources[name] = {
            "fused_block_stage": (csrc + "fused_block_stage.cu",
                                  "scripts/debug_fused_block.py:108"),
            "conv3x3_bpc": (csrc + ("conv3x3_wgmma.cu" if name in wgmma_heights
                                    else "conv3x3.cu"), "scripts/profile_pallas_conv.py:83"),
            "tiled_mm": (csrc + "tiled_mm.cu", "scripts/profile_conv_alternatives.py:188"),
            "qblock_part": (csrc + ("qblock.cu" if name == "qblock_part[full]"
                                    else "qblock_parts.cu"), "scripts/profile_qblock_parts.py:140"),
            "dot_chain": (csrc + "chain_wgmma.cu", "scripts/profile_qblock_parts.py:217"),
        }[family]
    for name in train_kernels:
        sources[name] = (csrc + "train_bn.cu", "none (XLA fuses the train path's chain)")
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

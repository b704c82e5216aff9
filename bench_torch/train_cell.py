"""Mixes of kind `train_epochs`: self-play training epochs through
`SelfPlayTrainer.run_epoch`, back to back, as the trainer runs them.

Set-up builds one trainer from the cell's configuration, loads the seed's
weights (`init_state` of the configuration's arch/<architecture>.py) and
runs one epoch, the warm-up of every shape, with every env at the initial
position as a user's run starts. That same trainer then runs the window.
Two epochs are checked: the set-up's, from the seed's weights and a fresh
optimizer, and one of the window's first three, drawn from the seed, from
the parameters, BatchNorm statistics and optimizer state it starts with
(copied before it runs). While an epoch
is checked, recorders on public surfaces keep what it did:
`trainer.env_core.step` (the engine's transitions), the rollout's
`masked_policy_sample` (what it stored), forward hooks on `trainer.model`
(the rollout's outputs; the bits of each update minibatch's input and the
first three outputs), `PPOUpdate.backward` (each minibatch's row indices)
and step hooks on `trainer.optimizer` (the first clipped gradient; the
parameters after the third step). After the window the reference follows
each checked epoch's first three steps (`check`), and the rules reference
plays the games of a few envs, followed through the whole run
(engine_check.py).
"""

from __future__ import annotations

import copy
import dataclasses
import math
import os
import random
import statistics
import time

import torch

from . import engine_check
from . import reference as R
from .compare import answer_gaps
from .flops import training_flops
from .trace import DeviceTrace

CHECKED_STEPS = 3
TRACKED_ENVS = 32
WINDOW_CHECKED = 3  # the checked window epoch is one of its first three


def build_config(cell, seed: int, tmp: str):
    from keisei_tpu_torch.training.config import config_from_dict
    raw = copy.deepcopy(cell.config)
    raw.setdefault("training", {}).update(cell.traffic.get("training", {}))
    raw["training"]["seed"] = int(seed)
    raw["training"]["checkpoint_dir"] = os.path.join(tmp, "checkpoints")
    raw.setdefault("display", {})["db_path"] = os.path.join(tmp, "observer.db")
    return config_from_dict(raw, source=cell.name)


def hyperparameters(config) -> dict:
    hp = dataclasses.asdict(config.algorithm_params)
    tc = config.training
    hp["entropy_warmup_epochs"] = tc.entropy_warmup_epochs
    hp["entropy_warmup_coeff"] = tc.entropy_warmup_coeff
    return hp


def entropy_coeff(hp: dict, epoch: int) -> float:
    """The entropy coefficient of an epoch: warm-up, then a linear decay
    from the warm-up coefficient to lambda_entropy."""
    base, start = hp["lambda_entropy"], hp["entropy_warmup_coeff"]
    warm, decay = hp["entropy_warmup_epochs"], hp["entropy_decay_epochs"]
    if warm > 0 and epoch < warm:
        return start
    if decay > 0 and epoch - warm < decay:
        return start + (base - start) * (epoch - warm) / decay
    return base


def snapshot(trainer) -> tuple[dict, dict]:
    """The model's state (float32) and the optimizer's state by parameter
    name: (step, first moment, second moment)."""
    model, opt = trainer.model, trainer.optimizer
    start = {n: t.detach().float().clone() for n, t in model.state_dict().items()}
    adam = {}
    for n, p in model.named_parameters():
        st = opt.state.get(p)
        if st:
            adam[n] = (int(st["step"]), st["exp_avg"].detach().float().clone(),
                       st["exp_avg_sq"].detach().float().clone())
    return start, adam


class Recorder:
    """One checked epoch, read through the trainer's public surfaces while
    `arm()`ed. `start`/`adam` None: the seed's weights, a fresh optimizer."""

    def __init__(self, trainer, start: dict | None = None, adam: dict | None = None):
        self.trainer, self.start, self.adam = trainer, start, adam
        self.epoch = trainer.epoch
        self.lr = float(trainer.optimizer.param_groups[0]["lr"])
        _, obs0, mask0 = trainer.env_carry
        self.obs0, self.mask0 = obs0.detach().clone(), mask0.detach().clone()
        self.steps: list = []
        self.samples: list = []
        self.eval_out: list = []
        self.ix: list = []
        self.rows_off: list = []
        self.train_out: list = []
        self.first_grads = None
        self.params_after = None
        self.opt_steps = 0
        self._rows = None
        self.names = [n for n, _ in trainer.model.named_parameters()]

    def arm(self):
        from keisei_tpu_torch.training import rollout
        from keisei_tpu_torch.training.ppo import PPOUpdate
        self._rollout_mod, sample = rollout, rollout.masked_policy_sample

        def recorded_sample(*args, **kwargs):
            out = sample(*args, **kwargs)
            if not self.ix:
                self.samples.append(tuple(t.detach().clone() for t in out))
            return out

        rollout.masked_policy_sample = recorded_sample
        self._sample = sample
        self._update_cls, backward = PPOUpdate, PPOUpdate.backward

        def recorded_backward(update, data, ix, *args, **kwargs):
            self.ix.append(ix.detach().clone())
            return backward(update, data, ix, *args, **kwargs)

        PPOUpdate.backward = recorded_backward
        self._backward = backward
        model, opt = self.trainer.model, self.trainer.optimizer
        self.handles = [
            model.register_forward_pre_hook(self._pre),
            model.register_forward_hook(self._post),
            opt.register_step_pre_hook(self._opt_pre),
            opt.register_step_post_hook(self._opt_post),
        ]

    def disarm(self):
        for h in self.handles:
            h.remove()
        self._rollout_mod.masked_policy_sample = self._sample
        self._update_cls.backward = self._backward
        self._rows = None

    def on_step(self, actions, eo):
        self.steps.append((actions.clone(), eo))

    def _pre(self, module, args):
        if not module.training or not self.ix:
            return
        if self._rows is None:  # the trajectory's observations, in the update's order
            obs = [self.obs0] + [eo.obs for _, eo in self.steps[:-1]]
            self._rows = torch.stack(obs).reshape(len(obs) * self.obs0.shape[0], -1)
        x = args[0].reshape(args[0].shape[0], -1)
        ix = self.ix[-1]
        want = self._rows[ix[:x.shape[0]]]
        differ = (x.contiguous().view(torch.int32) != want.view(torch.int32)).any(dim=1).sum()
        self.rows_off.append(differ + (ix.shape[0] - x.shape[0]))

    def _post(self, module, args, out):
        if not module.training:
            # the rollout's forwards come before the update's; an eval
            # forward after them (the observer's board snapshot) is not one
            if not self.ix:
                self.eval_out.append(tuple(t.detach().float().clone() for t in
                                           (out.policy_logits, out.value_logits, out.score_lead)))
        elif len(self.train_out) < CHECKED_STEPS:
            self.train_out.append(tuple(t.detach().float().clone() for t in
                                        (out.policy_logits, out.value_logits, out.score_lead)))

    def _opt_pre(self, opt, args, kwargs):
        if self.opt_steps == 0:
            params = dict(self.trainer.model.named_parameters())
            self.first_grads = {n: params[n].grad.detach().clone() for n in self.names}

    def _opt_post(self, opt, args, kwargs):
        self.opt_steps += 1
        if self.opt_steps == CHECKED_STEPS:
            self.params_after = {n: p.detach().clone()
                                 for n, p in self.trainer.model.named_parameters()}

    def transitions(self) -> tuple[R.Transitions, R.Outputs]:
        """The engine's transitions and the program's rollout outputs, in
        the rollout's order: a forward a ply, one more after a ply where a
        game was cut at max_ply alone, one after the last ply."""
        acts = torch.stack([a for a, _ in self.steps])
        eos = [eo for _, eo in self.steps]
        obs = torch.stack([self.obs0] + [eo.obs for eo in eos[:-1]])
        masks = torch.stack([self.mask0] + [eo.legal_mask for eo in eos[:-1]])
        trunc_plies = [t for t, eo in enumerate(eos) if bool((eo.truncated & ~eo.terminated).any())]
        tr = R.Transitions(
            obs=obs.reshape(obs.shape[0], obs.shape[1], -1), masks=masks, actions=acts,
            rewards=torch.stack([eo.reward for eo in eos]).float(),
            terminated=torch.stack([eo.terminated for eo in eos]),
            truncated=torch.stack([eo.truncated for eo in eos]),
            material=torch.stack([eo.material for eo in eos]),
            last_obs=eos[-1].obs.reshape(eos[-1].obs.shape[0], -1),
            terminal_obs={t: eos[t].terminal_obs.reshape(eos[t].terminal_obs.shape[0], -1)
                          for t in trunc_plies})
        T = len(eos)
        if len(self.eval_out) != T + 1 + len(trunc_plies):
            raise RuntimeError(f"the rollout made {len(self.eval_out)} forwards, not "
                               f"{T + 1 + len(trunc_plies)} ({T} plies)")
        plies, trunc, it = [], {}, iter(self.eval_out)
        for t in range(T):
            plies.append(next(it))
            if t in trunc_plies:
                trunc[t] = next(it)
        return tr, R.Outputs(plies, trunc, next(it))


@dataclasses.dataclass
class Setup:
    trainer: object
    tape: engine_check.Tape
    checked: list           # the checked epochs' Recorders
    state: dict             # the seed's weights
    arch: object            # the architecture's reference module
    widths: object          # its Widths
    hp: dict
    window_checked: int     # which window epoch is checked
    recorder: Recorder | None = None  # the one armed now


def setup(cell, seed: int, device, tmp: str) -> Setup:
    from keisei_tpu_torch.training.loop import SelfPlayTrainer
    config = build_config(cell, seed, tmp)
    trainer = SelfPlayTrainer(config, device=device)
    arch = cell.arch()
    widths = arch.Widths.from_params(config.model.params)
    state = arch.init_state(widths, seed, device)
    trainer.model.load_state_dict(state, strict=True)
    env = trainer.env_core
    tape = engine_check.Tape(env.num_envs, TRACKED_ENVS, seed, device, env.max_ply)
    s = Setup(trainer, tape, [], state, arch, widths, hyperparameters(config),
              random.Random(int(seed)).randrange(WINDOW_CHECKED))
    step = env.step

    def recorded_step(states, actions):
        states, eo = step(states, actions)
        tape.record(actions, eo)
        if s.recorder is not None:
            s.recorder.on_step(actions, eo)
        return states, eo

    env.step = recorded_step
    checked_epoch(s, Recorder(trainer))  # the warm-up
    return s


def checked_epoch(s: Setup, rec: Recorder):
    s.recorder = rec
    rec.arm()
    try:
        em = s.trainer.run_epoch()
    finally:
        rec.disarm()
        s.recorder = None
    s.checked.append(rec)
    s.tape.flush()
    return em


def _norms(tensors: dict) -> dict:
    return {n: float(t.float().norm()) for n, t in tensors.items()}


def _leaf_gaps(prog: dict, ref: dict, keep=None) -> dict:
    """leaf -> |prog - ref| / max(ref, the median leaf's ref), over `keep`."""
    names = [n for n in ref if keep is None or n in keep]
    med = statistics.median(ref[n] for n in names)
    return {n: abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30) for n in names}


def _diagnostics(losses, ref, grads, g_gaps, d_gaps, out1) -> dict:
    """Readings printed beside the compared numbers (calibrate.py)."""
    d = {"_grad_median": statistics.median(g_gaps.values()),
         "_grad_leaf": max(g_gaps, key=g_gaps.get), "_change_leaf": max(d_gaps, key=d_gaps.get)}
    if losses:
        d["_terms_step1"] = [float(abs(a - b) / max(abs(b), 1e-30))
                             for a, b in zip(losses[0], ref.losses[0])]
    if grads is not None:
        num = sum(float((grads[n].float() - g).norm()) ** 2 for n, g in ref.first_grads.items())
        den = sum(float(g.norm()) ** 2 for g in ref.first_grads.values())
        d["_grad_l2"] = math.sqrt(num / den)
    if out1:
        d["_out_rms_step1"] = [float((a.float() - b).norm() / b.norm())
                               for a, b in zip(out1, ref.first_outputs)]
    return d


def minibatch_rows_off(rec: Recorder, S: int, hp: dict) -> int:
    """Rows of the update's minibatches that are off: whose input bits
    differ from the trajectory's row that the minibatch's indices name, or
    that the forward left out; rows repeated within a PPO epoch; and the
    difference from the rows the update owes (epochs_per_batch x S //
    batch_size minibatches of batch_size)."""
    B, E = hp["batch_size"], hp["epochs_per_batch"]
    per_epoch = S // B
    off = abs(len(rec.ix) - E * per_epoch) * B
    off += int(sum(int(x) for x in rec.rows_off))
    for e in range(E):
        part = rec.ix[e * per_epoch:(e + 1) * per_epoch]
        got = torch.cat(part) if part else torch.zeros(0, dtype=torch.long)
        off += abs(per_epoch * B - got.numel()) + got.numel() - torch.unique(got).numel()
    return off


def readings(run: Setup, rec: Recorder, quant=None) -> dict:
    """One checked epoch's numbers: the program's against the float32
    reference's (or, with `quant`, the reference computed in that precision
    in the program's place)."""
    hp = dict(run.hp, learning_rate=rec.lr)
    start = run.state if rec.start is None else rec.start
    with R.full_precision():
        tr, prog_out = rec.transitions()
        S = tr.obs.shape[0] * tr.obs.shape[1]
        off = minibatch_rows_off(rec, S, hp)
        mbs = rec.ix[:CHECKED_STEPS]
        ent = entropy_coeff(hp, rec.epoch)
        names = run.arch.parameter_names(run.widths)
        ref_net = run.arch.Net(run.widths)
        blocks = run.arch.TRAIN_ROWS_PER_BLOCK
        ref_rows = R.training_rows(tr, R.rollout_outputs(ref_net, start, tr), hp)
        ref = R.follow_steps(ref_net, start, ref_rows, mbs, hp, ent, names, rec.adam, blocks)
        if len(rec.samples) != tr.actions.shape[0]:
            raise RuntimeError(f"the rollout sampled {len(rec.samples)} times, not "
                               f"{tr.actions.shape[0]}")
        if quant is None:
            answers = answer_gaps(torch.stack([x[1] for x in rec.samples]),
                                  torch.stack([x[2] for x in rec.samples]),
                                  ref_rows["old_log_probs"], ref_rows["values"], tr.masks,
                                  tr.actions, tr.obs)
            rows = R.training_rows(tr, prog_out, hp)
            losses = []
            for out, ix in zip(rec.train_out, mbs):
                mb = {k: v[ix] for k, v in rows.items()}
                with torch.no_grad():
                    losses.append(R.ppo_terms(out, mb, hp, ent))
            grads, params = rec.first_grads, rec.params_after
            out1 = rec.train_out[0] if rec.train_out else None
        else:
            net = run.arch.Net(run.widths, quant=quant)
            rows = R.training_rows(tr, R.rollout_outputs(net, start, tr), hp)
            answers = answer_gaps(rows["old_log_probs"], rows["values"],
                                  ref_rows["old_log_probs"], ref_rows["values"], tr.masks,
                                  tr.actions)
            ctl = R.follow_steps(net, start, rows, mbs, hp, ent, names, rec.adam, blocks)
            losses, grads, params = ctl.losses, ctl.first_grads, ctl.params
            out1 = ctl.first_outputs
    # each step's loss against the reference's, over the sum of the
    # magnitudes of the reference's terms (the total can pass through 0)
    steps = [float(abs(p.sum() - r.sum()) / r.abs().sum()) for p, r in zip(losses, ref.losses)]
    loss_gap = max(steps) if len(steps) == CHECKED_STEPS else math.inf
    g_ref = _norms(ref.first_grads)
    g_prog = _norms(grads) if grads is not None else {n: 0.0 for n in g_ref}
    med = statistics.median(g_ref.values())
    moved = {n for n, v in g_ref.items() if v >= 1e-3 * med}
    d_ref = _norms({n: ref.params[n] - start[n] for n in names})
    d_prog = _norms({n: params[n].float() - start[n] for n in names}) \
        if params is not None else {n: 0.0 for n in names}
    g_gaps, d_gaps = _leaf_gaps(g_prog, g_ref), _leaf_gaps(d_prog, d_ref, moved)
    logits = float((out1[0].float() - ref.first_outputs[0]).norm()
                   / ref.first_outputs[0].norm()) if out1 else math.inf
    return {"minibatch_rows_off": off,
            **answers,
            "step1_logits_gap": logits,
            "change_gap": max(d_gaps.values()),
            # the median leaf's: steady where the worst leaf, a small SE or
            # pooling layer, swings with the seed (PERF.md §2)
            "change_median": statistics.median(d_gaps.values()),
            # not compared: what calibrate.py prints beside the numbers
            "_loss_gap": loss_gap, "_grad_gap": max(g_gaps.values()),
            "_loss_steps": steps, "_left_out": sorted(set(names) - moved),
            **_diagnostics(losses, ref, grads, g_gaps, d_gaps, out1)}


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float, tmp: str) -> dict:
    s = setup(cell, seed, device, tmp)
    tr = s.trainer
    n, T = tr.config.training.num_games, tr.T
    setup_s = time.monotonic() - t0
    epochs, ends, start = [], [], time.monotonic()
    while True:
        if len(epochs) == s.window_checked:
            epochs.append(checked_epoch(s, Recorder(tr, *snapshot(tr))))
        else:
            epochs.append(tr.run_epoch())
            s.tape.flush()
        ends.append(time.monotonic() - start)
        if ends[-1] >= seconds and len(epochs) > s.window_checked:
            break
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.monotonic() - start
    record = {"N": n, "T": T, "hp": s.hp, "epochs": [e.as_dict() for e in epochs],
              "window_s": wall, "widths": dataclasses.asdict(s.widths),
              "on_card": device.type == "cuda",
              "window_flops": window_flops(s.arch, s.widths, s.hp, n, T, epochs),
              "unit_s": [b - a for a, b in zip([0.0] + ends, ends)]}
    if trace:
        record["traced"] = traced_epoch(s, device)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    failed = sum(1 for e in epochs
                 if not all(math.isfinite(e.as_dict()[k]) for k in ("policy_loss", "value_loss")))
    s.trainer.close()
    s.trainer = None
    for rec in s.checked:
        rec.trainer = None
    return {"units": len(epochs), "failed": failed, "setup_s": setup_s,
            "e2e": {"train_env_steps_per_s": n * T * len(epochs) / wall},
            "record": record, "peak": peak, "setup": s}


def window_flops(arch, widths, hp: dict, n: int, T: int, epochs: list) -> float:
    """The model FLOPs the window's epochs need, by the architecture's
    per-board count: the board forwards of the rollout (N a ply and one
    after the last, and the envs cut at max_ply) and every trained row."""
    rows = hp["epochs_per_batch"] * (n * T // hp["batch_size"]) * hp["batch_size"]
    boards = sum(n * (T + 1) + e.truncated for e in epochs)
    return training_flops(widths, boards, rows * len(epochs), arch.forward_flops)


def traced_epoch(s: Setup, device) -> dict:
    """One more epoch under a device trace (CUPTI adds 6-17% to a b40c256
    epoch); the host spans are the epoch's rollout, update and upkeep by
    EpochMetrics' times."""
    tr = s.trainer
    with DeviceTrace(device) as dt:
        t = time.time_ns()
        em = tr.run_epoch()
    s.tape.flush()
    r0 = t + int(em.rollout_time * 1e9)
    r1 = r0 + int(em.update_time * 1e9)
    return dt.summary([("rollout", t, r0), ("update", r0, r1), ("upkeep", r1, dt.t1)])


EXACT = ("minibatch_rows_off", "illegal_actions")


def check(s: Setup, limits: dict, control: bool = False) -> dict:
    """The compared numbers (with `control`, the float8 reference in the
    program's place): the exact ones summed over the checked epochs, the
    others of each, the window epoch's under "window."; the engine's
    transitions against the rules reference; and readings not compared."""
    quant = R.fp8_e4m3 if control else None
    first, window = (readings(s, rec, quant) for rec in s.checked)
    got = {k: v for k, v in first.items() if not k.startswith("_")}
    got.update({f"window.{k}": v for k, v in window.items()
                if not k.startswith("_") and k not in EXACT})
    for k in EXACT:
        got[k] = first[k] + window[k]
    got.update(engine_check.check(s.tape))
    for name, r in (("setup", first), ("window", window)):
        got.update({f"_{name}.{k}": v for k, v in r.items()})
    return got

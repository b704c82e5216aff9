"""Mixes of kind `rollout_calls`: self-play rollouts through the rollout that
`make_selfplay_rollout` returns, one call after another with the env state
carried, no update (the weights stay those of the seed).

The mix names the rollout's forward (`forward`: "fused", the bf16 kernels,
or "eager") and the env batch; every env starts at the initial position.
Each call's answers, a sample of rows drawn from the seed, are kept for
`check`: the observation, legal mask, sampled action, its log-probability
and the value. The env core and the forward are thin proxies (public
parameters of make_selfplay_rollout): the env core's keeps the transitions
of a few envs for the rules reference (engine_check.py); with a trace, both
mark host spans, and CUDA events go around each engine step.
"""

from __future__ import annotations

import dataclasses
import random
import time

import torch

from . import engine_check
from . import reference as R
from .compare import answer_gaps
from .trace import DeviceTrace, HostSpans
from .train_cell import build_config

ROWS_PER_CALL = 128
TRACED_CALLS = 3
TRACKED_ENVS = 8


class EnvProxy:
    """An EnvCore whose step marks a host span, records CUDA events around
    itself while `events` is a list, and then hands its transition to the
    tape."""

    def __init__(self, env, spans: HostSpans, tape: engine_check.Tape):
        self.env, self.tape = env, tape
        self.num_envs, self.num_channels = env.num_envs, env.num_channels
        self.action_space, self.device = env.action_space, env.device
        self.events = None
        self._step = spans.wrap("env_step", env.step)

    def init(self):
        return self.env.init()

    def step(self, states, actions):
        if self.events is None:
            out = self._step(states, actions)
        else:
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            out = self._step(states, actions)
            b.record()
            self.events.append((a, b))
        self.tape.record(actions, out[1])
        return out


class ForwardProxy:
    """A rollout forward that marks a host span per call and counts calls."""

    def __init__(self, fwd, spans: HostSpans):
        self.fwd, self.calls = fwd, 0
        self._call = spans.wrap("forward", fwd.__call__)

    def prepare(self, model):
        return self.fwd.prepare(model)

    def __call__(self, w, obs):
        self.calls += 1
        return self._call(w, obs)


@dataclasses.dataclass
class Kept:
    obs: list = dataclasses.field(default_factory=list)
    masks: list = dataclasses.field(default_factory=list)
    actions: list = dataclasses.field(default_factory=list)
    log_probs: list = dataclasses.field(default_factory=list)
    values: list = dataclasses.field(default_factory=list)

    def keep(self, traj, rows: torch.Tensor):
        flat = lambda t: t.reshape(-1, *t.shape[2:])  # noqa: E731
        self.obs.append(flat(traj.obs)[rows].reshape(rows.numel(), -1))
        self.masks.append(flat(traj.legal_masks)[rows])
        self.actions.append(flat(traj.actions)[rows])
        self.log_probs.append(flat(traj.log_probs)[rows])
        self.values.append(flat(traj.values)[rows])

    def cat(self) -> dict:
        return {k: torch.cat(v) for k, v in dataclasses.asdict(self).items()}


def make_forward(kind: str, model_cfg):
    if kind == "fused":
        from keisei_tpu_torch.models.fused_infer import make_fused_forward
        return make_fused_forward(model_cfg)
    if kind == "int8":
        from keisei_tpu_torch.models.fused_infer import make_quantized_forward
        return make_quantized_forward(model_cfg)
    if kind == "eager":
        return None
    raise ValueError(f"unknown rollout forward {kind!r}")


@dataclasses.dataclass
class Setup:
    rollout: object
    carry: tuple
    generator: torch.Generator
    model: object
    model_cfg: object
    params: dict
    state: dict
    architecture: str
    arch: object            # the architecture's reference module
    widths: object          # its Widths
    blend: float
    N: int
    T: int
    env: EnvProxy
    fwd: ForwardProxy | None
    spans: HostSpans
    tape: engine_check.Tape


def setup(cell, seed: int, device, tmp: str, forward: str | None = None) -> Setup:
    from keisei_tpu_torch.env.vec_env import EnvCore
    from keisei_tpu_torch.models.registry import build_model, get_model_contract
    from keisei_tpu_torch.training.rollout import make_selfplay_rollout
    from keisei_tpu_torch.training.value_adapter import get_value_adapter
    config = build_config(cell, seed, tmp)
    tc, ap = config.training, config.algorithm_params
    arch = cell.arch()
    widths = arch.Widths.from_params(config.model.params)
    model, model_cfg = build_model(config.model.architecture, config.model.params)
    model.to(device)
    state = arch.init_state(widths, seed, device)
    model.load_state_dict(state, strict=True)
    model.eval()
    adapter = get_value_adapter(get_model_contract(config.model.architecture),
                                lambda_value=ap.lambda_value, lambda_score=ap.lambda_score,
                                score_blend_alpha=ap.score_blend_alpha)
    spans = HostSpans()
    tape = engine_check.Tape(tc.num_games, TRACKED_ENVS, seed, device, tc.max_ply)
    env = EnvProxy(EnvCore(tc.num_games, tc.max_ply, widths.obs_channels, device), spans, tape)
    fwd = make_forward(forward or cell.traffic["forward"], model_cfg)
    proxy = ForwardProxy(fwd, spans) if fwd is not None else None
    T = tc.effective_steps_per_epoch
    rollout = make_selfplay_rollout(env, model, adapter, T, forward_fn=proxy)
    carry = env.init()
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    s = Setup(rollout, carry, g, model, model_cfg, dict(config.model.params), state,
              config.model.architecture, arch, widths,
              ap.score_blend_alpha,
              tc.num_games, T, env, proxy, spans, tape)
    call(s)  # the warm-up: every shape, the kernels built and loaded
    return s


def call(s: Setup):
    """One rollout call: (trajectory, next value, the envs cut at max_ply)."""
    carry, traj, next_value, stats = s.rollout(*s.carry, s.generator)
    s.carry = carry
    s.tape.flush()
    return traj, next_value, stats.truncated


def run(cell, seed: int, seconds: float, trace: bool, device, t0: float, tmp: str) -> dict:
    s = setup(cell, seed, device, tmp)
    setup_s = time.monotonic() - t0
    pick = random.Random(int(seed))
    kept, n_values, calls, ends, truncated = Kept(), [], 0, [], 0
    if trace and device.type == "cuda":
        s.env.events = []
    start = time.monotonic()
    while True:
        traj, next_value, cut = call(s)
        truncated += cut
        rows = torch.tensor(pick.sample(range(s.T * s.N), ROWS_PER_CALL), device=device)
        kept.keep(traj, rows)
        n_values.append(next_value)
        calls += 1
        ends.append(time.monotonic() - start)
        if ends[-1] >= seconds:
            break
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.monotonic() - start
    record = {"N": s.N, "T": s.T, "calls": calls, "window_s": wall,
              "widths": dataclasses.asdict(s.widths), "on_card": device.type == "cuda",
              "unit_s": [b - a for a, b in zip([0.0] + ends, ends)]}
    # the board forwards the algorithm needs: N a ply and one after the
    # last, and the envs cut at max_ply
    record["window_flops"] = s.arch.forward_flops(s.widths) * (s.N * (s.T + 1) * calls
                                                               + truncated)
    if trace:
        record["engine_ms"] = [a.elapsed_time(b) for a, b in s.env.events or ()]
        s.env.events = None
        record["traced"] = traced_calls(s, device)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    failed = int((~torch.isfinite(torch.stack(n_values))).any(dim=1).sum())
    s.rollout = s.carry = s.model = s.env = s.fwd = None
    return {"units": calls, "failed": failed, "setup_s": setup_s,
            "e2e": {"selfplay_env_steps_per_s": s.N * s.T * calls / wall},
            "record": record, "peak": peak, "setup": s, "kept": kept.cat()}


def traced_calls(s: Setup, device) -> dict:
    before = s.fwd.calls if s.fwd is not None else 0
    s.spans.on = True
    with DeviceTrace(device) as dt:
        for _ in range(TRACED_CALLS):
            call(s)
    s.spans.on = False
    summary = dt.summary(s.spans.spans)
    forwards = (s.fwd.calls - before) if s.fwd is not None else None
    summary["forwards"] = forwards
    summary["boards_per_forward"] = s.N
    return summary


def answers(net_or_fwd, s: Setup, kept: dict, chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(log-prob of the kept action, value) of every kept row."""
    lp, vals = [], []
    for i in range(0, kept["obs"].shape[0], chunk):
        obs = kept["obs"][i:i + chunk]
        pol, vl, sc = net_or_fwd(obs)
        lp.append(R.masked_log_softmax(pol, kept["masks"][i:i + chunk])
                  .gather(1, kept["actions"][i:i + chunk][:, None])[:, 0])
        vals.append(R.scalar_value(vl, sc, s.blend))
    return torch.cat(lp), torch.cat(vals)


def reference_answers(s: Setup, kept: dict, quant=None):
    net = s.arch.Net(s.widths, quant=quant)
    with R.full_precision(), torch.no_grad():
        return answers(lambda o: net.forward(s.state, o, train=False), s, kept, 512)


def readings(s: Setup, kept: dict, control: bool = False) -> dict:
    """The program's kept answers against the float32 reference's; with
    `control`, the architecture's control in the program's place: the
    program's other forward (`ROLLOUT_CONTROL`) over the kept rows, in
    chunks of the cell's batch, or the reference in float8."""
    ref_lp, ref_v = reference_answers(s, kept)
    if not control:
        lp, v = kept["log_probs"], kept["values"]
    elif s.arch.ROLLOUT_CONTROL is None:
        lp, v = reference_answers(s, kept, quant=R.fp8_e4m3)
    else:
        from keisei_tpu_torch.models.registry import build_model
        model, cfg = build_model(s.architecture, s.params)
        model.to(ref_lp.device).load_state_dict(s.state)
        fwd = make_forward(s.arch.ROLLOUT_CONTROL, cfg)
        w = fwd.prepare(model.eval())

        def run_fwd(obs):
            out = fwd(w, obs.reshape(obs.shape[0], s.widths.obs_channels, 9, 9))
            return out.policy_logits, out.value_logits, out.score_lead
        n = kept["obs"].shape[0] // 32 * 32
        kept = {k: v[:n] for k, v in kept.items()}
        ref_lp, ref_v = ref_lp[:n], ref_v[:n]
        with torch.no_grad():
            lp, v = answers(run_fwd, s, kept, s.N)
    return answer_gaps(lp, v, ref_lp, ref_v, kept["masks"], kept["actions"], kept["obs"])


def check(s: Setup, kept: dict, limits: dict, control: bool = False) -> dict:
    """The kept answers against the reference's (with `control`, the
    architecture's control's), and the engine's transitions against the
    rules reference."""
    got = readings(s, kept, control)
    got.update(engine_check.check(s.tape))
    return got

"""The plain float32 reference of the SE-ResNet self-play learner: the eval
and train forward, the rollout's bookkeeping (log-probs, values, the
truncation and ply-alternation bootstraps), GAE, the KataGo-PPO loss, the
global-norm clip and Adam, written from the model's equations.

It imports nothing of the program and no kernel. Matmuls and convolutions
run in float32 with TF32 off (`full_precision()`); `quant=fp8_e4m3` puts the
inputs and weights of every convolution and bf16 Dense layer through
float8 (e4m3, one scale per tensor): the control, one precision below the
program's bfloat16.

Weights: `init_state(widths, seed, device)` draws every weight from the seed
in one call of a device generator (PyTorch's default bounds, U(-1/sqrt(fan_in),
1/sqrt(fan_in))), with BatchNorm scale 1, shift 0 and statistics (0, 1). The
benchmark loads this state into the program, and the reference draws it
again; the keys are the program's state-dict names.

Model (per block): conv-BN-ReLU plus a bias from FC(mean || max || std of the
block input), conv-BN, SE scale and shift, residual, ReLU. Heads: policy
1x1 conv-BN-ReLU, 1x1 conv with bias -> (B, 9, 9, 139); the trunk's global
pool -> W/D/L logits and the score lead. BatchNorm in train mode takes the
batch's mean and biased variance (E[x^2] - E[x]^2, clipped at 0), eps 1e-5;
the pool's std is the population std with 1e-10 inside the sqrt.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

SPATIAL_MOVE_TYPES = 139
BN_EPS = 1e-5
ILLEGAL_LOGIT = -1e9
FP8_MAX = 448.0


@dataclass(frozen=True)
class Widths:
    num_blocks: int
    channels: int
    se_reduction: int
    global_pool_channels: int
    policy_channels: int
    value_fc_size: int
    score_fc_size: int
    obs_channels: int

    @classmethod
    def from_params(cls, params: dict) -> "Widths":
        return cls(**{k: int(params[k]) for k in cls.__dataclass_fields__})


@contextlib.contextmanager
def full_precision():
    """float32 matmuls and convolutions without TF32, restored on exit."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


# -- weights ---------------------------------------------------------------------------

def weight_shapes(w: Widths) -> dict[str, tuple[tuple[int, ...], int]]:
    """name -> (shape, fan_in) of every randomly drawn tensor, in draw order."""
    C, gpc, sec = w.channels, w.global_pool_channels, w.channels // w.se_reduction
    out: dict[str, tuple[tuple[int, ...], int]] = {}

    def conv(name, cout, cin, k):
        out[f"{name}.weight"] = ((cout, cin, k, k), cin * k * k)

    def dense(name, fout, fin):
        out[f"{name}.weight"] = ((fout, fin), fin)
        out[f"{name}.bias"] = ((fout,), fin)

    conv("input_conv", C, w.obs_channels, 3)
    for i in range(w.num_blocks):
        p = f"block{i}"
        conv(f"{p}.conv1", C, C, 3)
        dense(f"{p}.gp_fc1", gpc, 3 * C)
        dense(f"{p}.gp_fc2", C, gpc)
        conv(f"{p}.conv2", C, C, 3)
        dense(f"{p}.se_fc1", sec, C)
        dense(f"{p}.se_fc2", 2 * C, sec)
    conv("policy_conv1", w.policy_channels, C, 1)
    conv("policy_conv2", SPATIAL_MOVE_TYPES, w.policy_channels, 1)
    out["policy_conv2.bias"] = ((SPATIAL_MOVE_TYPES,), w.policy_channels)
    dense("value_fc1", w.value_fc_size, 3 * C)
    dense("value_fc2", 3, w.value_fc_size)
    dense("score_fc1", w.score_fc_size, 3 * C)
    dense("score_fc2", 1, w.score_fc_size)
    return out


def batchnorm_names(w: Widths) -> dict[str, int]:
    """BatchNorm layer -> channels."""
    bns = {"input_bn": w.channels}
    for i in range(w.num_blocks):
        bns[f"block{i}.bn1"] = w.channels
        bns[f"block{i}.bn2"] = w.channels
    bns["policy_bn1"] = w.policy_channels
    return bns


def init_state(w: Widths, seed: int, device) -> dict[str, torch.Tensor]:
    """The full state (parameters and BatchNorm statistics) from `seed`:
    one uniform draw on `device` for every random tensor."""
    shapes = weight_shapes(w)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    total = sum(math.prod(s) for s, _ in shapes.values())
    u = torch.rand(total, generator=g, device=device).mul_(2.0).sub_(1.0)
    state, at = {}, 0
    for name, (shape, fan_in) in shapes.items():
        n = math.prod(shape)
        state[name] = (u[at:at + n] / math.sqrt(fan_in)).reshape(shape)
        at += n
    for name, c in batchnorm_names(w).items():
        state[f"{name}.weight"] = torch.ones(c, device=device)
        state[f"{name}.bias"] = torch.zeros(c, device=device)
        state[f"{name}.running_mean"] = torch.zeros(c, device=device)
        state[f"{name}.running_var"] = torch.ones(c, device=device)
    return state


def parameter_names(w: Widths) -> list[str]:
    """The trainable tensors (everything but the BatchNorm statistics)."""
    names = list(weight_shapes(w))
    for bn in batchnorm_names(w):
        names += [f"{bn}.weight", f"{bn}.bias"]
    return names


# -- forward ---------------------------------------------------------------------------

def fp8_e4m3(t: torch.Tensor) -> torch.Tensor:
    """t through float8 e4m3 with one scale per tensor (amax -> 448); the
    gradient passes straight through."""
    scale = t.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    q = (t.detach() / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale
    return t + (q - t).detach()


def _same(t: torch.Tensor) -> torch.Tensor:
    return t


class Net:
    """forward(P, obs, train) over a state dict P; `quant` is applied to the
    inputs and weights of every conv and bf16-class Dense layer."""

    def __init__(self, w: Widths, quant=None):
        self.w = w
        self.q = quant or _same

    def conv(self, x, weight, bias=None):
        k = weight.shape[-1]
        return F.conv2d(self.q(x), self.q(weight), bias, padding=k // 2)

    def dense(self, x, P, name, quantized=True):
        q = self.q if quantized else _same
        return F.linear(q(x), q(P[f"{name}.weight"]), P[f"{name}.bias"])

    @staticmethod
    def bn(x, P, name, train):
        if train:
            mean = x.mean(dim=(0, 2, 3))
            var = torch.clamp((x * x).mean(dim=(0, 2, 3)) - mean * mean, min=0.0)
        else:
            mean, var = P[f"{name}.running_mean"], P[f"{name}.running_var"]
        mul = torch.rsqrt(var + BN_EPS) * P[f"{name}.weight"]
        return (x - mean[None, :, None, None]) * mul[None, :, None, None] \
            + P[f"{name}.bias"][None, :, None, None]

    @staticmethod
    def pool(x):
        mean = x.mean(dim=(2, 3))
        var = ((x - mean[:, :, None, None]) ** 2).mean(dim=(2, 3))
        return torch.cat([mean, x.amax(dim=(2, 3)), torch.sqrt(var + 1e-10)], dim=1)

    def block(self, x, P, p, train):
        out = F.relu(self.bn(self.conv(x, P[f"{p}.conv1.weight"]), P, f"{p}.bn1", train))
        g = self.dense(F.relu(self.dense(self.pool(x), P, f"{p}.gp_fc1")), P, f"{p}.gp_fc2")
        out = out + g[:, :, None, None]
        out = self.bn(self.conv(out, P[f"{p}.conv2.weight"]), P, f"{p}.bn2", train)
        se = self.dense(F.relu(self.dense(out.mean(dim=(2, 3)), P, f"{p}.se_fc1")),
                        P, f"{p}.se_fc2")
        scale, shift = se.chunk(2, dim=1)
        out = out * torch.sigmoid(scale)[:, :, None, None] + shift[:, :, None, None]
        return F.relu(out + x)

    def forward(self, P, obs, train: bool):
        """(policy logits (B, 9, 9, 139), W/D/L logits (B, 3), score (B, 1))."""
        x = obs.reshape(obs.shape[0], self.w.obs_channels, 9, 9).float()
        x = F.relu(self.bn(self.conv(x, P["input_conv.weight"]), P, "input_bn", train))
        for i in range(self.w.num_blocks):
            x = self.block(x, P, f"block{i}", train)
        pol = F.relu(self.bn(self.conv(x, P["policy_conv1.weight"]), P, "policy_bn1", train))
        pol = self.conv(pol, P["policy_conv2.weight"], P["policy_conv2.bias"])
        pool = self.pool(x)
        v = F.relu(self.dense(pool, P, "value_fc1"))
        s = F.relu(self.dense(pool, P, "score_fc1"))
        # the two last Dense layers run in float32 in the model
        value = self.dense(v, P, "value_fc2", quantized=False)
        score = self.dense(s, P, "score_fc2", quantized=False)
        return pol.permute(0, 2, 3, 1), value, score

    def eval_rows(self, P, obs, rows: int = 512):
        """The eval forward in blocks of `rows` boards, without gradients."""
        outs = []
        with torch.no_grad():
            for i in range(0, obs.shape[0], rows):
                outs.append(self.forward(P, obs[i:i + rows], train=False))
        return tuple(torch.cat(parts) for parts in zip(*outs))


# -- rollout bookkeeping, GAE, loss, optimizer -----------------------------------------

def masked_log_softmax(policy_logits, mask):
    b = mask.shape[0]
    return F.log_softmax(torch.where(mask, policy_logits.reshape(b, -1).float(), ILLEGAL_LOGIT),
                         dim=-1)


def scalar_value(value_logits, score, blend: float):
    """P(W) - P(L), blended with tanh(score) by `blend`."""
    p = torch.softmax(value_logits.float(), dim=-1)
    v = p[:, 0] - p[:, 2]
    if blend > 0.0:
        v = (1.0 - blend) * v + blend * torch.tanh(score[:, 0].float())
    return v


@dataclass
class Transitions:
    """One rollout as the engine produced it: (T, N, ...) per ply, plus the
    observations after the last ply and the terminal observations of the
    plies where a game was cut at max_ply."""

    obs: torch.Tensor          # (T, N, C*81) f32
    masks: torch.Tensor        # (T, N, A) bool
    actions: torch.Tensor      # (T, N) int64
    rewards: torch.Tensor      # (T, N) f32, last mover's
    terminated: torch.Tensor   # (T, N) bool
    truncated: torch.Tensor    # (T, N) bool
    material: torch.Tensor     # (T, N) int32, last mover's
    last_obs: torch.Tensor     # (N, C*81)
    terminal_obs: dict         # ply -> (N, C*81), plies with a truncation only


@dataclass
class Outputs:
    """The rollout's forwards: one per ply, one per truncation ply, one after
    the last ply; each (policy logits, value logits, score)."""

    plies: list
    truncation: dict
    last: tuple


def rollout_outputs(net: Net, P, tr: Transitions) -> Outputs:
    T = tr.obs.shape[0]
    plies = [net.eval_rows(P, tr.obs[t]) for t in range(T)]
    trunc = {t: net.eval_rows(P, o) for t, o in tr.terminal_obs.items()}
    return Outputs(plies, trunc, net.eval_rows(P, tr.last_obs))


def training_rows(tr: Transitions, out: Outputs, hp: dict) -> dict[str, torch.Tensor]:
    """The (S, ...) rows the PPO update trains on, from the rollout's
    transitions and its forwards' outputs: old log-probs, values, the
    bootstraps, GAE (negamax alternation, the chain cut at every game end,
    the bootstrap zeroed at terminations only), normalised advantages."""
    T, N = tr.actions.shape
    blend = hp["score_blend_alpha"]
    logp = torch.stack([masked_log_softmax(o[0], tr.masks[t]).gather(
        1, tr.actions[t][:, None])[:, 0] for t, o in enumerate(out.plies)])
    values = torch.stack([scalar_value(o[1], o[2], blend) for o in out.plies])
    dones = tr.terminated | tr.truncated
    override = torch.full((T, N), float("nan"), device=values.device)
    for t, o in out.truncation.items():
        trunc_only = tr.truncated[t] & ~tr.terminated[t]
        override[t] = torch.where(trunc_only, -scalar_value(o[1], o[2], blend), float("nan"))
    fill = torch.isnan(override[:-1]) & ~tr.terminated[:-1]
    override[:-1] = torch.where(fill, -values[1:], override[:-1])
    next_value = -scalar_value(out.last[1], out.last[2], blend)

    gamma, lam = hp["gamma"], hp["gae_lambda"]
    term = tr.terminated if hp["use_terminated_for_gae"] else dones
    next_vals = torch.cat([values[1:], next_value[None]])
    has_ov = ~torch.isnan(override)
    next_vals = torch.where(has_ov, override, next_vals)
    boot = torch.where(has_ov, 1.0, 1.0 - term.float())
    delta = tr.rewards + gamma * next_vals * boot - values
    decay = -gamma * lam * (1.0 - dones.float())
    adv = torch.empty_like(delta)
    carry = torch.zeros(N, device=delta.device)
    for t in range(T - 1, -1, -1):
        carry = delta[t] + decay[t] * carry
        adv[t] = carry
    returns = adv + values
    a = adv.reshape(-1)
    a = (a - a.mean()) / (a.std(unbiased=False) + 1e-8)
    cats = torch.where(tr.rewards > 0, 0, torch.where(tr.rewards < 0, 2, 1))
    cats = torch.where(tr.terminated, cats, -1).long()
    S = T * N
    return {
        "values": values.reshape(S),
        "obs": tr.obs.reshape(S, -1), "actions": tr.actions.reshape(S),
        "old_log_probs": logp.reshape(S), "advantages": a, "returns": returns.reshape(S),
        "legal_masks": tr.masks.reshape(S, -1), "value_cats": cats.reshape(S),
        "score_targets": tr.material.reshape(S).float() / hp["score_normalization"],
    }


def ppo_terms(outputs, mb: dict, hp: dict, entropy_coeff: float) -> torch.Tensor:
    """The KataGo-PPO loss of one minibatch as its four weighted terms:
    clipped surrogate, W/D/L cross-entropy over labelled rows, score MSE,
    and the legal-move entropy (negated); the loss is their sum."""
    pol, value_logits, score = outputs
    logp_all = masked_log_softmax(pol, mb["legal_masks"])
    new_logp = logp_all.gather(1, mb["actions"][:, None])[:, 0]
    ratio = torch.exp(new_logp - mb["old_log_probs"])
    adv = mb["advantages"]
    eps = hp["clip_epsilon"]
    policy = -torch.minimum(ratio * adv, torch.clamp(ratio, 1 - eps, 1 + eps) * adv).mean()
    entropy = (-(torch.exp(logp_all) * torch.where(mb["legal_masks"], logp_all, 0.0))
               .sum(dim=-1)).mean()
    cats = mb["value_cats"]
    valid = cats >= 0
    ce = -F.log_softmax(value_logits.float(), dim=-1).gather(1, cats.clamp(min=0)[:, None])[:, 0]
    n = valid.sum()
    wdl = torch.where(valid, ce, 0.0).sum() / torch.clamp(n, min=1)
    sq = ((score[:, 0].float() - mb["score_targets"]) ** 2).mean()
    return torch.stack([hp["lambda_policy"] * policy, hp["lambda_value"] * wdl,
                        hp["lambda_score"] * sq, -entropy_coeff * entropy])


def clip_by_global_norm_(grads: list[torch.Tensor], max_norm: float) -> None:
    norm = torch.sqrt(sum((g * g).sum() for g in grads))
    scale = torch.where(norm < max_norm, 1.0, max_norm / norm)
    for g in grads:
        g.mul_(scale)


class Adam:
    """Adam (b1 0.9, b2 0.999, eps 1e-8 outside the sqrt, bias-corrected),
    from zero moments or from `state`: (steps taken, first moment, second
    moment) of each parameter, in the order of `params`."""

    def __init__(self, params: list[torch.Tensor], lr: float, state: list | None = None):
        self.params, self.lr = params, lr
        if state is None:
            self.t = 0
            self.m = [torch.zeros_like(p) for p in params]
            self.v = [torch.zeros_like(p) for p in params]
        else:
            self.t = state[0][0]
            self.m = [m.clone() for _, m, _ in state]
            self.v = [v.clone() for _, _, v in state]

    @torch.no_grad()
    def step(self, grads: list[torch.Tensor]) -> None:
        self.t += 1
        c1, c2 = 1 - 0.9 ** self.t, 1 - 0.999 ** self.t
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            m.mul_(0.9).add_(g, alpha=0.1)
            v.mul_(0.999).addcmul_(g, g, value=0.001)
            p.sub_(self.lr * (m / c1) / (torch.sqrt(v / c2) + 1e-8))


@dataclass
class Steps:
    """What the reference reads over its first steps: each step's loss
    terms, the first clipped gradient per tensor, and the parameters after
    the last."""

    losses: list
    first_grads: dict
    params: dict
    first_outputs: tuple = ()


def follow_steps(net: Net, state: dict, rows: dict, minibatches: list[torch.Tensor],
                 hp: dict, entropy_coeff: float, names: list[str],
                 adam: dict | None = None) -> Steps:
    """Train a copy of `state` on `minibatches` (index tensors into `rows`)
    one Adam step each, as the program's update does; from the optimizer
    state `adam` (name -> (steps, first moment, second moment)) or a fresh
    one."""
    P = {k: v.detach().clone() for k, v in state.items()}
    params = [P[n].requires_grad_(True) for n in names]
    opt = Adam(params, hp["learning_rate"], [adam[n] for n in names] if adam else None)
    losses, first, first_out = [], None, ()
    for k, ix in enumerate(minibatches):
        mb = {key: v[ix] for key, v in rows.items()}
        out = net.forward(P, mb["obs"], train=True)
        if k == 0:
            first_out = tuple(t.detach().clone() for t in out)
        terms = ppo_terms(out, mb, hp, entropy_coeff)
        grads = torch.autograd.grad(terms.sum(), params)
        grads = [g.detach().clone() for g in grads]
        clip_by_global_norm_(grads, hp["grad_clip"])
        if k == 0:
            first = {n: g.clone() for n, g in zip(names, grads)}
        opt.step(grads)
        losses.append(terms.detach())
    return Steps(losses, first, {n: P[n].detach() for n in names}, first_out)

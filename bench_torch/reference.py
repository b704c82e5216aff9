"""The plain float32 reference of the self-play learner around the model:
the rollout's bookkeeping (log-probs, values, the truncation and
ply-alternation bootstraps), GAE, the KataGo-PPO loss, the global-norm clip
and Adam, written from the algorithm's equations. The model itself is an
architecture's module, arch/<architecture>.py (arch/__init__.py gives the
contract); the SE-ResNet's names are still reachable here.

It imports nothing of the program and no kernel. Matmuls and convolutions
run in float32 with TF32 off (`full_precision()`); `quant=fp8_e4m3` puts
what the configuration runs in bf16 through float8 (e4m3, one scale per
tensor): the control, one precision below the program's bfloat16.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from pathlib import Path

import torch
import torch.nn.functional as F

SPATIAL_MOVE_TYPES = 139
ILLEGAL_LOGIT = -1e9
FP8_MAX = 448.0


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


def fp8_e4m3(t: torch.Tensor) -> torch.Tensor:
    """t through float8 e4m3 with one scale per tensor (amax -> 448); the
    gradient passes straight through."""
    scale = t.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    q = (t.detach() / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale
    return t + (q - t).detach()


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


def rollout_outputs(net, P, tr: Transitions) -> Outputs:
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


def ppo_terms(outputs, mb: dict, hp: dict, entropy_coeff: float,
              rows: int | None = None, labelled=None) -> torch.Tensor:
    """The KataGo-PPO loss of one minibatch as its four weighted terms:
    clipped surrogate, W/D/L cross-entropy over labelled rows, score MSE,
    and the legal-move entropy (negated); the loss is their sum. Given the
    minibatch's `rows` and its count of `labelled` rows, `mb` is a block of
    it, and the terms are the block's share of the minibatch's means."""
    pol, value_logits, score = outputs

    def mean(x):
        return x.mean() if rows is None else x.sum() / rows
    logp_all = masked_log_softmax(pol, mb["legal_masks"])
    new_logp = logp_all.gather(1, mb["actions"][:, None])[:, 0]
    ratio = torch.exp(new_logp - mb["old_log_probs"])
    adv = mb["advantages"]
    eps = hp["clip_epsilon"]
    policy = -mean(torch.minimum(ratio * adv, torch.clamp(ratio, 1 - eps, 1 + eps) * adv))
    entropy = mean(-(torch.exp(logp_all) * torch.where(mb["legal_masks"], logp_all, 0.0))
                   .sum(dim=-1))
    cats = mb["value_cats"]
    valid = cats >= 0
    ce = -F.log_softmax(value_logits.float(), dim=-1).gather(1, cats.clamp(min=0)[:, None])[:, 0]
    n = valid.sum() if labelled is None else labelled
    wdl = torch.where(valid, ce, 0.0).sum() / torch.clamp(n, min=1)
    sq = mean((score[:, 0].float() - mb["score_targets"]) ** 2)
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


def follow_steps(net, state: dict, rows: dict, minibatches: list[torch.Tensor],
                 hp: dict, entropy_coeff: float, names: list[str],
                 adam: dict | None = None, block_rows: int | None = None) -> Steps:
    """Train a copy of `state` on `minibatches` (index tensors into `rows`)
    one Adam step each, as the program's update does; from the optimizer
    state `adam` (name -> (steps, first moment, second moment)) or a fresh
    one. With `block_rows` (the architecture's TRAIN_ROWS_PER_BLOCK), each
    minibatch goes through the forward and backward in blocks of that many
    rows, and the blocks' terms and gradients are summed before the clip;
    with None, in one."""
    P = {k: v.detach().clone() for k, v in state.items()}
    params = [P[n].requires_grad_(True) for n in names]
    opt = Adam(params, hp["learning_rate"], [adam[n] for n in names] if adam else None)
    whole = block_rows is None
    losses, first, first_out = [], None, ()
    for k, ix in enumerate(minibatches):
        n_rows = None if whole else ix.shape[0]
        labelled = None if whole else (rows["value_cats"][ix] >= 0).sum()
        terms, grads, outs = None, None, []
        for b in [ix] if whole else ix.split(block_rows):
            mb = {key: v[b] for key, v in rows.items()}
            out = net.forward(P, mb["obs"], train=True)
            if k == 0:
                outs.append(tuple(t.detach().clone() for t in out))
            t = ppo_terms(out, mb, hp, entropy_coeff, n_rows, labelled)
            g = [x.detach().clone() for x in torch.autograd.grad(t.sum(), params)]
            if grads is None:
                terms, grads = t.detach(), g
            else:
                terms = terms + t.detach()
                for acc, x in zip(grads, g):
                    acc.add_(x)
        clip_by_global_norm_(grads, hp["grad_clip"])
        if k == 0:
            # one block keeps the forward's own layout (the reading's sums follow it)
            first_out = outs[0] if whole else tuple(torch.cat(parts) for parts in zip(*outs))
            first = {n: g.clone() for n, g in zip(names, grads)}
        opt.step(grads)
        losses.append(terms)
    return Steps(losses, first, {n: P[n].detach() for n in names}, first_out)


# -- the SE-ResNet, which moved to arch/se_resnet.py ------------------------------------

def se_resnet():
    """arch/se_resnet.py, the module behind the SE-ResNet's names here."""
    from bench_torch.arch import load
    return load(Path(__file__).resolve().parent, "se_resnet")


_MOVED = {"BN_EPS", "Widths", "weight_shapes", "batchnorm_names", "init_state",
          "parameter_names", "Net"}


def __getattr__(name: str):
    # looked up on first use, since arch/se_resnet.py imports this module
    if name in _MOVED:
        return getattr(se_resnet(), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

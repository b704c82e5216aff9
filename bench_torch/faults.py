"""Faults planted in the program, for the readings that set the limits of
`correct` (calibrate.py) and for the test that sees `correct` come out
false under each (tests/test_faults.py). Each is a context manager that
patches one public function or method of the program and restores it.

- `state_unchanged`: the optimizer's step leaves the parameters as they were.
- `half_batch`: the PPO update trains each minibatch on its first half of
  rows alone, the means taken over those.
- `answer_altered`: the rollout stores, for every env, another legal action
  than the one whose log-probability it stores.
- `engine_stale_action`: from its second call on, the engine's step plays
  the actions it was given the call before (a stale input), and returns
  what those produce.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(owner, name: str, make):
    orig = getattr(owner, name)
    setattr(owner, name, make(orig))
    try:
        yield
    finally:
        setattr(owner, name, orig)


def state_unchanged():
    return _patched(torch.optim.Adam, "step", lambda orig: lambda self, *a, **k: None)


def half_batch():
    from keisei_tpu_torch.training.ppo import PPOUpdate

    def make(orig):
        def backward(self, data, ix, entropy_coeff):
            return orig(self, data, ix[: ix.shape[0] // 2], entropy_coeff)
        return backward
    return _patched(PPOUpdate, "backward", make)


def answer_altered():
    from keisei_tpu_torch.training import rollout

    def make(orig):
        def sample(out, legal_masks, adapter, generator=None, actions=None):
            acts, log_probs, values = orig(out, legal_masks, adapter, generator, actions)
            first_legal = legal_masks.int().argmax(dim=1)
            return first_legal, log_probs, values
        return sample
    return _patched(rollout, "masked_policy_sample", make)


def engine_stale_action():
    from keisei_tpu_torch.env.vec_env import EnvCore

    def make(orig):
        last = {}

        def step(self, states, actions):
            played = last.get(id(self), actions)
            last[id(self)] = actions.clone()
            return orig(self, states, played)
        return step
    return _patched(EnvCore, "step", make)


FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch,
          "answer_altered": answer_altered, "engine_stale_action": engine_stale_action}

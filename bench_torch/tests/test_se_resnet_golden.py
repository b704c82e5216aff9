"""The SE-ResNet's plain reference, pinned: at tiny widths and fixed seeds,
a checksum of the seed's weights, the forward's outputs in train and eval
mode and the three losses of the reference's PPO steps, as the reference
gave them before it moved into arch/se_resnet.py. The weights must match
exactly; the outputs and losses to rtol 1e-6, since a CPU's float32 sums
may differ in the last bit between machines.

    python -m pytest bench_torch/tests -q -p no:cacheprovider
"""

from __future__ import annotations

import hashlib

import pytest
import torch

from bench_torch import reference as R
from bench_torch.arch import load
from bench_torch.spec import ROOT

TINY = dict(num_blocks=2, channels=32, se_reduction=16, global_pool_channels=16,
            policy_channels=8, value_fc_size=16, score_fc_size=8, obs_channels=50)
SEED = 2 ** 31 + 77
HP = dict(score_blend_alpha=0.3, gamma=0.99, gae_lambda=0.95, use_terminated_for_gae=True,
          score_normalization=76.0, clip_epsilon=0.2, lambda_policy=1.0, lambda_value=1.5,
          lambda_score=0.1, learning_rate=1e-3, grad_clip=1.0)

# computed with the reference as it stood before the move
STATE_SHA256 = "2de13fa28ec34c7cecb93887379b3caa4a8ee0229b70141ded23c3a9f5157887"
OUTPUTS = {
    False: [  # policy, W/D/L, score: sum, sum of |x|, sum of x^2
        [1587.6199866180464, 13203.214188004418, 3377.838705143656],
        [-2.4771184250712395, 2.49037204682827, 0.7626739259343354],
        [-1.8564639389514923, 1.8564639389514923, 0.5750956434576286]],
    True: [  # policy, W/D/L, score: sum, sum of |x|, sum of x^2
        [1544.655853976485, 23447.716193464537, 13432.62976765414],
        [-4.392148718237877, 4.392148718237877, 1.3094272612675788],
        [-2.230525642633438, 2.230525642633438, 0.8379729314733373]],
}
LOSSES = [  # each step's four terms
    [0.19160325825214386, 1.530529260635376, 0.011422066949307919, -0.062456294894218445],
    [0.33493882417678833, 1.484734058380127, 0.01187030877918005, -0.062268633395433426],
    [-0.6302461624145508, 1.8185065984725952, 0.007264986634254456, -0.062347330152988434]]
FIRST_OUTPUTS = [  # the first step's outputs: sum, sum of |x|, sum of x^2, then strides
    [2054.505422799502, 30986.03334926204, 17740.574392648505, 11259, 9, 1, 81],
    [-6.466471970081329, 6.466471970081329, 2.165118994698265, 3, 1],
    [-2.927423447370529, 2.927423447370529, 1.081868209924358, 1, 1]]


def state_checksum(state: dict) -> str:
    h = hashlib.sha256()
    for name in sorted(state):
        h.update(name.encode())
        h.update(state[name].contiguous().numpy().tobytes())
    return h.hexdigest()


def observations(n: int, channels: int, seed: int) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return (torch.rand(n, channels * 81, generator=g) < 0.2).float()


def transitions(T: int, N: int, channels: int, seed: int, legal: float = 0.05) -> R.Transitions:
    """A rollout of T plies over N envs, drawn from `seed`: legal masks,
    actions among them, games ending at random (decided or drawn) and env 2
    cut at max_ply on ply 1."""
    g = torch.Generator().manual_seed(seed)
    A = 81 * 139
    masks = torch.rand(T, N, A, generator=g) < legal
    masks[..., 0] = True
    actions = torch.where(masks, torch.rand(T, N, A, generator=g), -1.0).argmax(dim=-1)
    terminated = torch.rand(T, N, generator=g) < 0.2
    outcome = torch.randint(-1, 2, (T, N), generator=g).float()
    truncated = torch.zeros(T, N, dtype=torch.bool)
    truncated[1, 2], terminated[1, 2] = True, False
    return R.Transitions(
        obs=(torch.rand(T, N, channels * 81, generator=g) < 0.2).float(), masks=masks,
        actions=actions, rewards=torch.where(terminated, outcome, 0.0), terminated=terminated,
        truncated=truncated, material=torch.randint(-20, 21, (T, N), generator=g,
                                                    dtype=torch.int32),
        last_obs=(torch.rand(N, channels * 81, generator=g) < 0.2).float(),
        terminal_obs={1: (torch.rand(N, channels * 81, generator=g) < 0.2).float()})


def summary(t: torch.Tensor) -> list[float]:
    """Sum, sum of magnitudes and sum of squares, in float64."""
    t = t.double()
    return [float(t.sum()), float(t.abs().sum()), float((t * t).sum())]


def readings(m) -> dict:
    """What is pinned, from the module `m` that holds the SE-ResNet."""
    w = m.Widths.from_params(TINY)
    state = m.init_state(w, SEED, "cpu")
    net = m.Net(w)
    obs = observations(6, w.obs_channels, 3)
    out = {}
    with torch.no_grad():
        for train in (False, True):
            out[train] = [summary(t) for t in net.forward(state, obs, train)]
    tr = transitions(3, 8, w.obs_channels, 5)
    rows = R.training_rows(tr, R.rollout_outputs(net, state, tr), HP)
    perm = torch.randperm(24, generator=torch.Generator().manual_seed(7))
    mbs = [perm[:8], perm[8:16], perm[16:]]
    steps = R.follow_steps(net, state, rows, mbs, HP, 0.01, m.parameter_names(w))
    return {"state": state_checksum(state), "outputs": out,
            "losses": [[float(x) for x in terms] for terms in steps.losses],
            "first": [summary(t) + list(t.stride()) for t in steps.first_outputs]}


@pytest.fixture(scope="module")
def moved():
    return readings(load(ROOT, "se_resnet"))


def test_the_seeds_weights_are_as_before_the_move(moved):
    assert moved["state"] == STATE_SHA256


@pytest.mark.parametrize("train", [False, True])
def test_the_forward_is_as_before_the_move(moved, train):
    for got, want in zip(moved["outputs"][train], OUTPUTS[train]):
        # the plain sum can cancel: held to the sum of magnitudes' scale
        assert got[0] == pytest.approx(want[0], rel=0, abs=1e-6 * want[1])
        assert got[1:] == pytest.approx(want[1:], rel=1e-6, abs=0)


def test_the_reference_steps_losses_are_as_before_the_move(moved):
    for got, want in zip(moved["losses"], LOSSES, strict=True):
        assert got == pytest.approx(want, rel=1e-6, abs=1e-9)


def test_the_reference_steps_first_outputs_keep_the_forwards_layout(moved):
    """The first step's outputs as the forward gave them, strides too: a
    norm taken over them sums in the order of their layout, and a copy in
    another layout moves the compared readings in their last bits."""
    for got, want in zip(moved["first"], FIRST_OUTPUTS, strict=True):
        assert got[0] == pytest.approx(want[0], rel=0, abs=1e-6 * want[1])
        assert got[1:3] == pytest.approx(want[1:3], rel=1e-6, abs=0)
        assert got[3:] == want[3:]

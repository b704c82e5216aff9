"""The SE-ResNet's train path on the kernels' plain versions
(models/se_resnet_train.py over ops/train_bn.py, as a CUDA tensor in
training mode takes it) against the eager module's written-out code, in
float32: values, gradients and running statistics.

On the CPU the module keeps the written-out code, so the tests route it
through the train path by patching `se_resnet._train_kernels`; the kernels'
plain versions then stand where the card launches the kernels. Sums are
taken in another order on the two sides (the sums of y and y^2 against
mean()), so values agree to float32 rounding: rtol 1e-4 of the largest.
"""

import copy

import pytest
import torch

from keisei_tpu_torch.models import se_resnet
from keisei_tpu_torch.models.registry import build_model
from keisei_tpu_torch.ops import train_bn
from keisei_tpu_torch.utils import tracing

torch.set_num_threads(2)

TINY = {"num_blocks": 2, "channels": 32, "global_pool_channels": 16, "se_reduction": 4,
        "dtype": "float32"}
RTOL = 1e-4


@pytest.fixture
def on_kernels(monkeypatch):
    """Train-mode forwards take the train path's functions on the CPU."""
    monkeypatch.setattr(se_resnet, "_train_kernels", lambda x: True)


def _close(got: torch.Tensor, want: torch.Tensor, what: str, rtol: float = RTOL):
    scale = max(float(want.abs().max()), 1e-6)
    err = float((got - want).abs().max())
    assert err <= rtol * scale, f"{what}: {err:.3g} against {scale:.3g}"


def _model(seed: int = 0, **kw):
    torch.manual_seed(seed)
    model, _ = build_model("se_resnet", {**TINY, **kw})
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.randn_like(p) * 0.1)
        for name, b in model.named_buffers():
            b.copy_(torch.rand_like(b) + 0.5 if "var" in name else torch.randn_like(b) * 0.1)
    return model.train()


def _obs(batch: int, seed: int) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return (torch.rand(batch, 50, 9, 9, generator=g) > 0.8).float()


def _loss(out) -> torch.Tensor:
    value_weights = torch.tensor([1.0, -2.0, 0.5])
    return (out.policy_logits.pow(2).mean() + (out.value_logits * value_weights).sum()
            + out.score_lead.pow(2).sum())


def _step(model, obs, **kw):
    """One train forward and backward: outputs, parameter gradients, buffers."""
    out = model(obs, **kw)
    _loss(out).backward()
    return (out, {n: p.grad.clone() for n, p in model.named_parameters()},
            {n: b.clone() for n, b in model.named_buffers()})


def _compare(got, want, rtol: float = RTOL):
    (go, gg, gb), (wo, wg, wb) = got, want
    for name in ("policy_logits", "value_logits", "score_lead"):
        _close(getattr(go, name).detach(), getattr(wo, name).detach(), name, rtol)
    for name in wg:
        _close(gg[name], wg[name], f"grad {name}", rtol)
    for name in wb:
        _close(gb[name].float(), wb[name].float(), name, rtol)


def _eager_then_kernels(monkeypatch, fn):
    """fn(model) on the written-out code, then on the train path, from the same state."""
    model = _model()
    twin = copy.deepcopy(model)
    want = fn(model)
    monkeypatch.setattr(se_resnet, "_train_kernels", lambda x: True)
    return fn(twin), want


@pytest.mark.parametrize("batch,seed", [(1, 0), (6, 1), (17, 2)])
def test_model_train_step_matches_eager(monkeypatch, batch, seed):
    obs = _obs(batch, seed)
    got, want = _eager_then_kernels(monkeypatch, lambda m: _step(m, obs))
    _compare(got, want)


@pytest.mark.parametrize("batch", [3, 8])
def test_block_matches_eager(monkeypatch, batch):
    """One GlobalPoolBiasBlock: its output and the gradients of its input
    and of every parameter (conv, BatchNorm, gp and SE FCs)."""
    torch.manual_seed(batch)
    block = se_resnet.GlobalPoolBiasBlock(32, 4, 16).train()
    x = torch.relu(torch.randn(batch, 32, 9, 9))
    x[0, 3] = 0  # a channel zero over a board: its max ties 81 ways
    dout = torch.randn(batch, 32, 9, 9)

    def run(blk):
        xi = x.clone().requires_grad_()
        out = blk(xi)
        out.backward(dout)
        return out.detach(), xi.grad, {n: p.grad.clone() for n, p in blk.named_parameters()}

    want = run(block)
    twin = copy.deepcopy(block)
    for p in twin.parameters():
        p.grad = None
    monkeypatch.setattr(se_resnet, "_train_kernels", lambda t: True)
    got = run(twin)
    _close(got[0], want[0], "out")
    _close(got[1], want[1], "dx")
    for name in want[2]:
        _close(got[2][name], want[2][name], f"grad {name}")


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("layer", ["input_bn", "policy_bn1"])
def test_batch_norm_matches_eager(monkeypatch, layer, relu):
    """input_bn and policy_bn1 (C=32), with and without the ReLU folded in:
    output, dx, dweight, dbias and the running statistics."""
    bn = getattr(_model(), layer)
    y = torch.randn(5, 32, 9, 9) * 2 + 0.5
    dout = torch.randn_like(y)

    def run(m):
        yi = y.clone().requires_grad_()
        out = m(yi, relu=relu)
        out.backward(dout)
        return out.detach(), yi.grad, m.weight.grad, m.bias.grad, m.running_mean, m.running_var

    twin = copy.deepcopy(bn)
    want = run(bn)
    monkeypatch.setattr(se_resnet, "_train_kernels", lambda t: True)
    got = run(twin)
    for name, a, b in zip(("out", "dx", "dweight", "dbias", "running_mean", "running_var"),
                          got, want):
        _close(a, b, name)


@pytest.mark.parametrize("pattern", ["zero_channel", "two_way_tie", "no_tie"])
def test_global_pool_matches_eager(on_kernels, pattern):
    """mean || max || std and its gradient; the max's gradient split evenly
    among tied squares, as torch.amax's backward splits it (a channel that
    is zero over a whole board after a ReLU ties 81 ways)."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn(4, 8, 9, 9, generator=g)
    if pattern == "zero_channel":
        x = torch.relu(x)
        x[1, 2] = 0
        x[3] = 0
    elif pattern == "two_way_tie":
        x[:, :, 4, 4] = x[:, :, 0, 0] = 5.0
    dpool = torch.randn(4, 24, generator=g)
    xa, xb = x.clone().requires_grad_(), x.clone().requires_grad_()
    want = se_resnet.global_pool(xa)
    want.backward(dpool)
    got = se_resnet.train_path.global_pool(xb)
    got.backward(dpool)
    _close(got.detach(), want.detach(), "pool")
    _close(xb.grad, xa.grad, "dx")


@pytest.mark.parametrize("value", [0.1, 1.0, -3.0])
def test_batch_norm_with_a_variance_clamped_at_zero(monkeypatch, value):
    """A channel constant over the batch: E[y^2] - E[y]^2 is 0 or a rounding
    below it, clamped at 0 (torch.clamp and its gradient) on both sides."""
    bn = se_resnet.FlaxBatchNorm(4).train()
    with torch.no_grad():
        bn.weight.copy_(torch.tensor([1.0, 0.5, 2.0, 1.5]))
    y = torch.randn(3, 4, 9, 9)
    y[:, 1] = value
    dout = torch.randn_like(y)

    def run(m):
        yi = y.clone().requires_grad_()
        out = m(yi)
        out.backward(dout)
        return out.detach(), yi.grad, m.weight.grad, m.bias.grad, m.running_var

    twin = copy.deepcopy(bn)
    want = run(bn)
    monkeypatch.setattr(se_resnet, "_train_kernels", lambda t: True)
    got = run(twin)
    assert float(want[4][1]) == pytest.approx(0.9, abs=1e-6)  # the batch variance read 0
    for name, a, b in zip(("out", "dx", "dweight", "dbias", "running_var"), got, want):
        _close(a, b, name, rtol=1e-3)


def test_recompute_blocks_moves_the_statistics_once(monkeypatch):
    """recompute_blocks on the train path (non-reentrant checkpoint, the
    blocks recomputed in the backward under _statistics_frozen): values,
    gradients and running statistics equal one plain forward's, so the
    statistics moved once."""
    obs = _obs(6, 4)
    got, want = _eager_then_kernels(monkeypatch,
                                    lambda m: _step(m, obs, recompute_blocks=True))
    _compare(got, want)
    plain_once = _step(_model(), obs)  # no recompute, written-out code
    for name, b in plain_once[2].items():
        _close(got[2][name].float(), b.float(), name)


@pytest.mark.parametrize("scale,share", [(2.0, 0.5), (1.0, 1.0), (3.0, 0.25)])
def test_synced_batch_stats_with_a_stand_in_reduce(monkeypatch, scale, share):
    """Under synced_batch_stats a stand-in reduce (the sum over `scale`
    equal ranks) feeds the same (C,)-sized step on both sides, forward and
    backward (its gradient flows through the reduce)."""
    obs = _obs(6, 5)

    def run(m):
        with se_resnet.synced_batch_stats(m, lambda t: t * scale, share):
            return _step(m, obs)

    got, want = _eager_then_kernels(monkeypatch, run)
    _compare(got, want)


def test_bn_train_counter_names_the_path(monkeypatch):
    """Each train-mode BatchNorm call counts `bn.train` and `bn.train.fused`
    on the train path, `bn.train.plain` on the written-out code; eval counts
    none."""
    model, obs = _model(), _obs(4, 6)
    runs = {}
    for path in ("plain", "fused"):
        if path == "fused":
            monkeypatch.setattr(se_resnet, "_train_kernels", lambda t: True)
        tracing.enable()
        try:
            model.train()
            model(obs)
            model.eval()
            with torch.no_grad():
                model(obs)
            runs[path] = dict(tracing.counters())
        finally:
            tracing.disable()
    n = 2 + 2 * TINY["num_blocks"]
    assert runs["plain"] == {"bn.train": n, "bn.train.plain": n}
    assert runs["fused"] == {"bn.train": n, "bn.train.fused": n}


def test_cpu_tensors_take_the_plain_versions():
    """On the CPU the wrappers run the plain versions and launch nothing."""
    wrappers = (train_bn.pool_stats, train_bn.bn_sums, train_bn.bn_apply)
    counts = [w.launches for w in wrappers]
    modes = dict(train_bn.bn_apply.mode_launches)
    y = torch.randn(2, 3, 9, 9)
    sums, rows = train_bn.bn_sums(y, per_row=True)
    _close(sums[0], y.sum(dim=(0, 2, 3)), "sum")
    _close(rows, y.sum(dim=(2, 3)), "rows")
    train_bn.pool_stats(y)
    af = (torch.zeros(3), torch.ones(3), torch.zeros(3))
    _close(train_bn.bn_apply("plain", y, af), y, "identity affine")
    assert counts == [w.launches for w in wrappers]
    assert modes == dict(train_bn.bn_apply.mode_launches)
    with pytest.raises(ValueError):
        train_bn.bn_apply("middle", y, af)


@pytest.mark.parametrize("mode", train_bn.MODES)
def test_grad_passes_are_the_apply_passes_gradient(mode):
    """bn_grad_sums and bn_grad_apply give, with the sums' gradients zero,
    the gradient of bn_apply at fixed statistics (autograd of the plain
    apply): mean, mul, beta, y, and the gp bias's or the SE output's."""
    g = torch.Generator().manual_seed(7)
    B, C = 3, 5
    y = torch.randn(B, C, 9, 9, generator=g)
    x = torch.relu(torch.randn(B, C, 9, 9, generator=g))
    af = [(torch.randn(C, generator=g) * 0.3).requires_grad_() for _ in range(3)]
    row = torch.randn(B, 2 * C if mode == "tail" else C, generator=g).requires_grad_()
    yl = y.clone().requires_grad_()
    kw = {"plain": dict(relu=True), "head": dict(g=row), "tail": dict(x=x, se=row)}[mode]
    out = train_bn.bn_apply_reference(mode, yl, af, **kw)
    dout = torch.randn(B, C, 9, 9, generator=g)
    out.backward(dout)
    af_d = tuple(t.detach() for t in af)
    okw = {"plain": dict(out=out.detach(), relu=True), "head": {},
           "tail": dict(out=out.detach(), se=row.detach())}[mode]
    d, drow, dres = train_bn.bn_grad_sums(mode, dout, y, af_d, **okw)
    for name, got, leaf in zip(("dmean", "dmul", "dbeta"), d, af):
        _close(got, leaf.grad, name)
    if mode != "plain":
        _close(drow, row.grad, "drow")
    grad, akw = dout, {"plain": dict(out=out.detach(), relu=True), "head": {}}.get(mode)
    if mode == "tail":
        grad, akw = dres, dict(se=row.detach())
    dy = train_bn.bn_grad_apply(mode, grad, y, af_d, torch.zeros(2, C), **akw)
    _close(dy, yl.grad, "dy")


def test_pool_backward_adds_the_residual_gradient():
    """pool_stats_backward's `add`: the block's residual gradient summed in
    its pass (the block's x receives conv1's, the pool's and the residual's)."""
    g = torch.Generator().manual_seed(8)
    x = torch.relu(torch.randn(2, 4, 9, 9, generator=g))
    pool = train_bn.pool_stats(x)
    dpool, add = torch.randn(2, 12, generator=g), torch.randn(2, 4, 9, 9, generator=g)
    _close(train_bn.pool_stats_backward(x, pool, dpool, add),
           train_bn.pool_stats_backward(x, pool, dpool) + add, "dx + add")


@pytest.mark.parametrize("with_se", [False, True])
def test_moments_gradient_is_batch_affines(with_se):
    """bn_moments_backward (closed form) against autograd through
    FlaxBatchNorm.batch_affine, from the sums, and the SE input
    (rows / 81 - mean) * mul + beta: one channel's variance rounds below 0
    and is clamped (its gradient through the variance is 0)."""
    g = torch.Generator().manual_seed(9)
    B, C, n = 4, 6, 4 * 81
    y = torch.randn(B, C, 81, generator=g)
    y[:, 2] = 0.1  # constant: E[y^2] - E[y]^2 is a rounding from 0
    sums = torch.stack([y.sum(dim=(0, 2)), (y * y).sum(dim=(0, 2))]).requires_grad_()
    rows = y.sum(dim=2).requires_grad_()
    bn = se_resnet.FlaxBatchNorm(C)
    with torch.no_grad():
        bn.weight.copy_(1 + 0.1 * torch.randn(C, generator=g))
    weight, bias = bn.weight, bn.bias
    mean, var_raw, mul = bn.batch_affine(*(sums / n), weight, "plain")
    beta = bias.float()
    d = [torch.randn(C, generator=g) for _ in range(3)]
    outs, grads = [mean, mul, beta], list(d)
    dse = None
    if with_se:
        dse = torch.randn(B, C, generator=g)
        outs.append((rows / 81 - mean) * mul + beta)
        grads.append(dse)
    want = torch.autograd.grad(outs, [sums, weight, bias, rows], grads, allow_unused=True)
    got = train_bn.bn_moments_backward(tuple(d), mean.detach(), mul.detach(), var_raw.detach(),
                                       weight.detach(), rows.detach() if with_se else None, dse,
                                       eps=se_resnet.BN_EPS, scale=1.0 / n)
    _close(got[0], want[0], "dsums")
    _close(got[1], want[1], "dweight")
    _close(got[2], want[2], "dbias")
    if with_se:
        _close(got[3], want[3], "drows")

"""The SE-ResNet's train-mode BatchNorm, global pool and block epilogues on
the kernels of ops/train_bn.py, as torch.autograd.Functions whose backward
is kernels too (models/se_resnet.py takes them on a CUDA tensor in training
mode; a CPU tensor runs the kernels' plain versions through the same
functions).

A BatchNorm here is three functions: a statistics function (the sums of y
and y^2, and for a block's bn2 each (b, c)'s sum over its squares); the
(C,)-sized step, FlaxBatchNorm.batch_affine in plain torch as the eager
path runs it (mean and E[y^2] from the sums, the all-reduce under
synced_batch_stats, the clamp, the running statistics, rsqrt * weight; for
bn2 also the SE input from the row sums), whose gradient is taken in closed
form by one kernel; and an apply function. Its backward is one reduction
pass (in the apply's backward: the gradients of mean, mul and beta, and of
the gp bias or the SE's output) and one elementwise pass (in the statistics
function's backward) that writes the whole gradient of y: the apply's term
and the sums' terms, which eager autograd would compute as two tensors and
add. The apply hands that pass its operands through a `_Link`, and claims
no gradient for y itself. Autograd runs the statistics function's backward
after the apply's, since the sums reach the apply only through the (C,)
step. In a block the tail's apply likewise hands the residual's gradient to
the pool's backward, which adds it in its own pass.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops import train_bn as K
from . import se_resnet  # imports this module first: read at call time

SQUARES = 81


class _Link:
    """What one function's backward leaves for another's, which runs later
    in the same backward."""

    __slots__ = ("grad", "kw", "add")

    def __init__(self):
        self.grad = self.kw = self.add = None


class _PoolStats(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, link):
        pool = K.pool_stats(x)
        ctx.link = link
        ctx.save_for_backward(x, pool)
        return pool

    @staticmethod
    def backward(ctx, dpool):
        x, pool = ctx.saved_tensors
        add = None
        if ctx.link is not None:
            add, ctx.link.add = ctx.link.add, None
        return K.pool_stats_backward(x, pool, dpool.contiguous(), add), None


def global_pool(x: torch.Tensor, link: _Link | None = None) -> torch.Tensor:
    """models/se_resnet.py:global_pool on the kernels: (B, 3C) f32. With a
    `link`, the backward adds the gradient another function left there."""
    return _PoolStats.apply(x, link)


class _Sums(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, link, mode):
        sums, rows = K.bn_sums(y, per_row=mode == "tail")
        ctx.link, ctx.mode = link, mode
        ctx.save_for_backward(y)
        return sums if rows is None else (sums, rows)

    @staticmethod
    def backward(ctx, dsums, drows=None):
        (y,) = ctx.saved_tensors
        link = ctx.link
        grad, kw = link.grad, link.kw
        link.grad = link.kw = None
        return K.bn_grad_apply(ctx.mode, grad, y, dsums=dsums, drow=drows, **kw), None, None


class _Apply(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, mean, mul, beta, g, x, se, link, pool_link, mode, relu):
        if g is not None:
            ctx.g_dtype, g = g.dtype, g.to(y.dtype)
        out = K.bn_apply(mode, y, (mean, mul, beta), relu=relu, x=x, g=g, se=se)
        masked = mode == "tail" or relu
        ctx.link, ctx.pool_link, ctx.mode, ctx.relu = link, pool_link, mode, relu
        ctx.save_for_backward(y, mean, mul, beta, out if masked else None, se)
        return out

    @staticmethod
    def backward(ctx, dout):
        y, mean, mul, beta, out, se = ctx.saved_tensors
        af, mode = (mean, mul, beta), ctx.mode
        dout = dout.contiguous()
        d, drow, dres = K.bn_grad_sums(mode, dout, y, af, out=out, se=se, relu=ctx.relu)
        ctx.link.grad = dres if mode == "tail" else dout
        ctx.link.kw = {"af": af, "out": out, "se": se, "relu": ctx.relu}
        dg = drow.to(ctx.g_dtype) if mode == "head" else None
        dx = dres
        if ctx.pool_link is not None:
            ctx.pool_link.add, dx = dres, None
        return (None, d[0], d[1], d[2], dg, dx, drow if mode == "tail" else None,
                None, None, None, None)


class _Moments(torch.autograd.Function):
    """(mean, mul, beta[, se_in]) from the sums through bn.batch_affine,
    run as the eager path runs it; se_in = (rows / 81 - mean) * mul + beta,
    the mean of bn2's output over each (b, c)'s squares. The backward is
    closed form (ops/train_bn.py:bn_moments_backward); under
    synced_batch_stats it sums the gradient of the global moments over the
    ranks with the same `reduce`, as the all-reduce's own backward does."""

    @staticmethod
    def forward(ctx, sums, rows, weight, bias, bn, n):
        mean, var_raw, mul = bn.batch_affine(*(sums / n), weight, "fused")
        beta = bias.detach().float()  # not the input itself, which .float() returns for f32
        ctx.sync, ctx.n, ctx.dtypes = bn.sync, n, (weight.dtype, bias.dtype)
        ctx.save_for_backward(mean, var_raw, mul, weight, rows)
        if rows is None:
            return mean, mul, beta
        return mean, mul, beta, (rows / SQUARES - mean) * mul + beta

    @staticmethod
    def backward(ctx, dmean, dmul, dbeta, dse=None):
        mean, var_raw, mul, weight, rows = ctx.saved_tensors
        scale = 1.0 if ctx.sync is not None else 1.0 / ctx.n
        dsums, dw, db, drows = K.bn_moments_backward(
            (dmean, dmul, dbeta), mean, mul, var_raw, weight.detach().float(), rows,
            None if rows is None else dse.contiguous(), eps=se_resnet.BN_EPS, scale=scale)
        if ctx.sync is not None:
            reduce, share = ctx.sync
            dsums = reduce(dsums.reshape(-1)).reshape(dsums.shape) * (share / ctx.n)
        return dsums, drows, dw.to(ctx.dtypes[0]), db.to(ctx.dtypes[1]), None, None


def _statistics(bn, y: torch.Tensor, link: _Link, mode: str):
    """The statistics function and the (C,)-sized step: (mean, mul, beta)
    and, for the tail, the SE input."""
    got = _Sums.apply(y, link, mode)
    sums, rows = got if mode == "tail" else (got, None)
    return _Moments.apply(sums, rows, bn.weight, bn.bias, bn, y.numel() // y.shape[1])


def batch_norm(bn, y: torch.Tensor, relu: bool) -> torch.Tensor:
    """FlaxBatchNorm `bn`'s train-mode forward of y (then a ReLU)."""
    link = _Link()
    mean, mul, beta = _statistics(bn, y, link, "plain")
    return _Apply.apply(y, mean, mul, beta, None, None, None, link, None, "plain", relu)


def block(blk, x: torch.Tensor) -> torch.Tensor:
    """GlobalPoolBiasBlock `blk`'s train-mode forward of x: conv1, bn1 and
    ReLU plus the gp bias (the head), conv2, bn2, SE and the residual's
    ReLU (the tail)."""
    pool_link, head, tail = _Link(), _Link(), _Link()
    g = blk.gp_fc2(F.relu(blk.gp_fc1(global_pool(x, pool_link))))
    y1 = blk.conv1(x)
    mean, mul, beta = _statistics(blk.bn1, y1, head, "head")
    h = _Apply.apply(y1, mean, mul, beta, g, None, None, head, None, "head", False)
    y2 = blk.conv2(h)
    mean, mul, beta, se_in = _statistics(blk.bn2, y2, tail, "tail")
    se = blk.se_fc2(F.relu(blk.se_fc1(se_in)))
    return _Apply.apply(y2, mean, mul, beta, None, x, se, tail, pool_link, "tail", False)

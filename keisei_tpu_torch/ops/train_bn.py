"""The SE-ResNet's train-mode BatchNorm, global pool and block epilogues as
hand-written CUDA kernels (csrc/train_bn.cu), each beside its plain PyTorch
version. They replace no TPU kernel: XLA fuses this chain for the JAX
package. models/se_resnet_train.py builds the train path's autograd
functions from them.

Activations are (B, C, 9, 9), contiguous, bf16 or f32 (the model's
params.dtype); the math is f32. `af` is a BatchNorm's (mean, mul, beta),
three (C,) f32 tensors, so that its output is z = (y - mean) * mul + beta,
taken in that order. The modes name the three places a BatchNorm sits:
"plain" (input_bn, policy_bn1; a ReLU optional), "head" (a block's bn1:
h = relu(z) + g[b, c], g the gp bias (B, C)) and "tail" (its bn2:
out = relu(z * sigmoid(s) + t + x), [s | t] = se (B, 2C), the SE's scale and
shift); g and se come in the activation's type.

    pool_stats(x)                              -> (B, 3C) mean | max | std
    pool_stats_backward(x, pool, dpool, add)   -> dx (+ add)
    bn_sums(y, per_row)                        -> (2, C) sums of y, y^2; (B, C) row sums
    bn_apply(mode, y, af, ...)                 -> the layer's output
    bn_grad_sums(mode, grad, y, af, ...)       -> (3, C) gradients of mean, mul, beta;
                                                  head: dg; tail: dse; the tail's dres
    bn_grad_apply(mode, grad, y, af, dsums, ...) -> dy
    bn_moments_backward(dapply, mean, mul, var_raw, w, rows, dse, eps, scale)
                                               (dapply: the apply's dmean, dmul, dbeta)
                                               -> the (C,)-sized step's gradients:
                                                  dsums, dw, db, drows

A CPU tensor takes the plain version; a CUDA tensor launches the kernels or
raises. Each wrapper counts its launches in `.launches`; the three that
take a mode count them per mode too, in the Counter `.mode_launches`.
"""

from __future__ import annotations

from collections import Counter

import torch

from . import _build

__all__ = ["pool_stats", "pool_stats_backward", "bn_sums", "bn_apply", "bn_grad_sums",
           "bn_grad_apply", "pool_stats_reference", "pool_stats_backward_reference",
           "bn_sums_reference", "bn_apply_reference", "bn_grad_sums_reference",
           "bn_grad_apply_reference", "bn_moments_backward", "bn_moments_backward_reference",
           "MODES", "CHUNK"]

SQUARES = 81
MODES = ("plain", "head", "tail")
CHUNK = 4  # boards of a reduction CTA (csrc/train_bn.cu kChunk)
_DTYPES = (torch.bfloat16, torch.float32)


# -- plain versions -------------------------------------------------------------------


def _col(v: torch.Tensor) -> torch.Tensor:
    """(C,) -> (1, C, 1, 1); (B, C) -> (B, C, 1, 1)."""
    return v[None, :, None, None] if v.dim() == 1 else v[:, :, None, None]


def _z(yf: torch.Tensor, af) -> torch.Tensor:
    mean, mul, beta = af
    return (yf - _col(mean)) * _col(mul) + _col(beta)


def _sig(se: torch.Tensor) -> torch.Tensor:
    return torch.sigmoid(se[:, :se.shape[1] // 2].float())


def pool_stats_reference(x: torch.Tensor) -> torch.Tensor:
    xf = x.float().flatten(2)
    mean = xf.sum(-1) / SQUARES
    var = ((xf - mean[..., None]) ** 2).sum(-1) / SQUARES
    return torch.cat([mean, xf.amax(-1), torch.sqrt(var + 1e-10)], dim=1)


def pool_stats_backward_reference(x, pool, dpool, add=None) -> torch.Tensor:
    xf = x.float().flatten(2)
    mean, mx, sd = pool.chunk(3, dim=1)
    dm, dmx, dsd = dpool.chunk(3, dim=1)
    tie = xf == mx[..., None]
    dx = (dm[..., None] / SQUARES + (dsd / (SQUARES * sd))[..., None] * (xf - mean[..., None])
          + tie * (dmx / tie.sum(-1))[..., None]).reshape(x.shape)
    if add is not None:
        dx = dx + add.float()
    return dx.to(x.dtype)


def bn_sums_reference(y, per_row: bool = False):
    yf = y.float()
    sums = torch.stack([yf.sum(dim=(0, 2, 3)), (yf * yf).sum(dim=(0, 2, 3))])
    return sums, (yf.sum(dim=(2, 3)) if per_row else None)


def bn_apply_reference(mode, y, af, *, relu=False, x=None, g=None, se=None):
    z = _z(y.float(), af)
    if mode == "plain":
        out = torch.relu(z) if relu else z
    elif mode == "head":
        out = torch.relu(z.to(y.dtype).float()) + _col(g.float())
    else:
        out = torch.relu(z * _col(_sig(se)) + _col(se[:, y.shape[1]:].float()) + x.float())
    return out.to(y.dtype)


def _dz(mode, gf, y, af, out, se, relu):
    """The gradient at z: the upstream one through the mode's ReLU (for the
    tail, where `gf` is already masked, through the SE scale)."""
    if mode == "plain":
        return torch.where(out > 0, gf, 0.0) if relu else gf
    if mode == "head":
        return torch.where(_z(y.float(), af).to(y.dtype) > 0, gf, 0.0)
    return gf * _col(_sig(se))


def bn_grad_sums_reference(mode, grad, y, af, *, out=None, se=None, relu=False):
    gf, yf = grad.float(), y.float()
    drow = dres = None
    if mode == "head":
        drow = gf.sum(dim=(2, 3)).to(y.dtype)
    if mode == "tail":
        gf = torch.where(out > 0, gf, 0.0)
        dres = gf.to(y.dtype)
        sig = _sig(se)
        drow = torch.cat([(gf * _z(yf, af)).sum(dim=(2, 3)) * sig * (1 - sig),
                          gf.sum(dim=(2, 3))], dim=1).to(y.dtype)
    dz = _dz(mode, gf, y, af, out, se, relu)
    a, b = dz.sum(dim=(0, 2, 3)), (dz * (yf - _col(af[0]))).sum(dim=(0, 2, 3))
    return torch.stack([-af[1] * a, b, a]), drow, dres


def bn_grad_apply_reference(mode, grad, y, af, dsums, *, out=None, se=None, drow=None,
                            relu=False):
    yf = y.float()
    dz = _dz(mode, grad.float(), y, af, out, se, relu)
    dy = dz * _col(af[1]) + (_col(dsums[0]) + 2 * yf * _col(dsums[1]))
    if drow is not None:
        dy = dy + _col(drow)
    return dy.to(y.dtype)


def bn_moments_backward_reference(dapply, mean, mul, var_raw, w, rows=None, dse=None, *,
                                  eps: float, scale: float):
    dmean, dmul, dbeta = dapply
    drows = None
    if rows is not None:
        dbeta = dbeta + dse.sum(dim=0)
        dmul = dmul + (dse * (rows / SQUARES - mean)).sum(dim=0)
        dmean = dmean - mul * dse.sum(dim=0)
        drows = dse * mul / SQUARES
    r = torch.rsqrt(var_raw.clamp(min=0.0) + eps)
    dvar = torch.where(var_raw >= 0, -0.5 * dmul * w * r * r * r, 0.0)
    return torch.stack([(dmean - 2 * mean * dvar) * scale, dvar * scale]), dmul * r, dbeta, drows


# -- kernels ----------------------------------------------------------------------------


def _check(y: torch.Tensor, *others) -> tuple[int, int]:
    """(B, C) of the activation `y`; raise on what the kernels do not take.
    `others`: (name, tensor, shape, dtype) of the operands given; a dtype of
    None means y's."""
    if y.dim() != 4 or y.shape[2:] != (9, 9):
        raise ValueError(f"expected an activation (B, C, 9, 9), got {tuple(y.shape)}")
    if y.dtype not in _DTYPES:
        raise TypeError(f"activations must be bfloat16 or float32, got {y.dtype}")
    if not y.is_cuda:
        raise ValueError(f"unsupported device {y.device}")
    if not y.is_contiguous():
        raise ValueError("the activation must be contiguous")
    dev = y.device
    for name, t, shape, dtype in others:
        if t is None:
            raise ValueError(f"{name} is required")
        if t.shape != shape:
            raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
        if t.dtype != (dtype or y.dtype):
            raise TypeError(f"{name} must be {dtype or y.dtype}, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name} on {t.device} but the activation on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return y.shape[0], y.shape[1]


def _ptr(t: torch.Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def _bf16(t: torch.Tensor) -> int:
    return int(t.dtype == torch.bfloat16)


def _stream(t: torch.Tensor) -> int:
    """The handle of the current CUDA stream on t's device."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def _mode(mode: str) -> int:
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    return MODES.index(mode)


def pool_stats(x: torch.Tensor) -> torch.Tensor:
    """mean || max || population std (+1e-10 in the sqrt) over the 81
    squares of each (b, c): (B, 3C) f32."""
    if x.device.type == "cpu":
        return pool_stats_reference(x)
    B, C = _check(x)
    lib = _build.load_library()
    pool = torch.empty((B, 3 * C), dtype=torch.float32, device=x.device)
    err = lib.keisei_pool_stats(x.data_ptr(), pool.data_ptr(), B, C, _bf16(x), _stream(x))
    _build.check(lib, err, "pool_stats launch")
    pool_stats.launches += 1
    return pool


pool_stats.launches = 0


def pool_stats_backward(x, pool, dpool, add=None) -> torch.Tensor:
    """dx of pool_stats: the mean's, the std's, and the max's split evenly
    among the squares tied at the max; plus `add` (like x) where given."""
    if x.device.type == "cpu":
        return pool_stats_backward_reference(x, pool, dpool, add)
    B, C = x.shape[:2]
    ops = [("pool", pool, (B, 3 * C), torch.float32), ("dpool", dpool, (B, 3 * C), torch.float32)]
    if add is not None:
        ops.append(("add", add, x.shape, None))
    _check(x, *ops)
    lib = _build.load_library()
    dx = torch.empty_like(x)
    err = lib.keisei_pool_stats_backward(x.data_ptr(), pool.data_ptr(), dpool.data_ptr(),
                                         _ptr(add), dx.data_ptr(), B, C, _bf16(x), _stream(x))
    _build.check(lib, err, "pool_stats_backward launch")
    pool_stats_backward.launches += 1
    return dx


pool_stats_backward.launches = 0


def _affine_ops(af, C: int) -> list:
    return [(name, t, (C,), torch.float32) for name, t in zip(("mean", "mul", "beta"), af)]


def _reduce(mode: int, y, *, g=None, out=None, af=(None, None, None), se=None,
            rows: bool = False, drow=None, relu: bool = False, dres: bool = False):
    """One keisei_bn_reduce call: its (2, C) or (3, C) sums, the rows' sums
    (f32, where asked), the residual's gradient (where asked)."""
    B, C = y.shape[:2]
    lib = _build.load_library()
    dev = y.device
    partials = torch.empty((2, C, -(-B // CHUNK)), dtype=torch.float32, device=dev)
    sums = torch.empty((2 if mode == 0 else 3, C), dtype=torch.float32, device=dev)
    row = torch.empty((B, C), dtype=torch.float32, device=dev) if rows else None
    res = torch.empty_like(y) if dres else None
    err = lib.keisei_bn_reduce(mode, _ptr(g), _ptr(out), y.data_ptr(), *map(_ptr, af), _ptr(se),
                               partials.data_ptr(), sums.data_ptr(), _ptr(row), _ptr(drow),
                               _ptr(res), B, C, int(relu), _bf16(y), _stream(y))
    _build.check(lib, err, "bn_reduce launch")
    return sums, row, res


def bn_sums(y: torch.Tensor, per_row: bool = False):
    """The (2, C) f32 sums of y and y^2 over boards and squares and, with
    `per_row`, the (B, C) f32 sums over each (b, c)'s squares (else None)."""
    if y.device.type == "cpu":
        return bn_sums_reference(y, per_row)
    _check(y)
    sums, rows, _ = _reduce(0, y, rows=per_row)
    bn_sums.launches += 1
    return sums, rows


bn_sums.launches = 0


def bn_apply(mode: str, y, af, *, relu=False, x=None, g=None, se=None):
    """plain: z (relu(z) with `relu`); head: relu(z) + g, g (B, C); tail:
    relu(z * sigmoid(s) + t + x), [s | t] = se (B, 2C); x, g, se like y."""
    m = _mode(mode)
    if y.device.type == "cpu":
        return bn_apply_reference(mode, y, af, relu=relu, x=x, g=g, se=se)
    B, C = y.shape[:2]
    ops = _affine_ops(af, C)
    if mode == "head":
        ops.append(("g", g, (B, C), None))
    if mode == "tail":
        ops += [("x", x, y.shape, None), ("se", se, (B, 2 * C), None)]
    _check(y, *ops)
    lib = _build.load_library()
    out = torch.empty_like(y)
    err = lib.keisei_bn_apply(m, y.data_ptr(), _ptr(x), *map(_ptr, af),
                              _ptr(g if mode == "head" else se), out.data_ptr(), B, C,
                              int(relu), _bf16(y), _stream(y))
    _build.check(lib, err, f"bn_apply({mode}) launch")
    bn_apply.launches += 1
    bn_apply.mode_launches[mode] += 1
    return out


bn_apply.launches = 0
bn_apply.mode_launches = Counter()


def bn_grad_sums(mode: str, grad, y, af, *, out=None, se=None, relu=False):
    """The (3, C) f32 gradients of mean, mul and beta through the apply
    (-mul * sum dz, sum dz (y - mean), sum dz; dz the gradient at z); the
    mode's row gradients in y's type: head (B, C), the gp bias's (the rows'
    sums of grad); tail (B, 2C), the SE scale's and shift's; else None; and
    the tail's residual gradient dres = grad * [out > 0], else None."""
    m = _mode(mode)
    if y.device.type == "cpu":
        return bn_grad_sums_reference(mode, grad, y, af, out=out, se=se, relu=relu)
    B, C = y.shape[:2]
    ops = [("grad", grad, y.shape, None), *_affine_ops(af, C)]
    masked = mode == "tail" or (mode == "plain" and relu)
    if masked:
        ops.append(("out", out, y.shape, None))
    if mode == "tail":
        ops.append(("se", se, (B, 2 * C), None))
    _check(y, *ops)
    drow = {"plain": None, "head": (B, C), "tail": (B, 2 * C)}[mode]
    drow = None if drow is None else torch.empty(drow, dtype=y.dtype, device=y.device)
    sums, _, dres = _reduce(m + 1, y, g=grad, out=out if masked else None, af=af,
                            se=se if mode == "tail" else None, drow=drow, relu=relu,
                            dres=mode == "tail")
    bn_grad_sums.launches += 1
    bn_grad_sums.mode_launches[mode] += 1
    return sums, drow, dres


bn_grad_sums.launches = 0
bn_grad_sums.mode_launches = Counter()


def bn_grad_apply(mode: str, grad, y, af, dsums, *, out=None, se=None, drow=None,
                  relu=False):
    """dy = dz * mul + dsums[0] + 2 y dsums[1] (+ drow[b, c], (B, C) f32):
    the gradient into the BatchNorm's input, every term in one pass. For the
    tail `grad` is bn_grad_sums' dres."""
    m = _mode(mode)
    if y.device.type == "cpu":
        return bn_grad_apply_reference(mode, grad, y, af, dsums, out=out, se=se, drow=drow,
                                       relu=relu)
    B, C = y.shape[:2]
    ops = [("grad", grad, y.shape, None), *_affine_ops(af, C),
           ("dsums", dsums, (2, C), torch.float32)]
    if mode == "plain" and relu:
        ops.append(("out", out, y.shape, None))
    if mode == "tail":
        ops.append(("se", se, (B, 2 * C), None))
    if drow is not None:
        ops.append(("drow", drow, (B, C), torch.float32))
    _check(y, *ops)
    lib = _build.load_library()
    dy = torch.empty_like(y)
    err = lib.keisei_bn_grad_apply(m + 1, grad.data_ptr(),
                                   _ptr(out if mode == "plain" and relu else None), y.data_ptr(),
                                   *map(_ptr, af), _ptr(se if mode == "tail" else None),
                                   dsums.data_ptr(), _ptr(drow), dy.data_ptr(), B, C, int(relu),
                                   _bf16(y), _stream(y))
    _build.check(lib, err, f"bn_grad_apply({mode}) launch")
    bn_grad_apply.launches += 1
    bn_grad_apply.mode_launches[mode] += 1
    return dy


bn_grad_apply.launches = 0
bn_grad_apply.mode_launches = Counter()


def bn_moments_backward(dapply, mean, mul, var_raw, w, rows=None, dse=None, *, eps: float,
                        scale: float):
    """The gradients through FlaxBatchNorm.batch_affine (and, with `rows`,
    the SE input (rows / 81 - mean) * mul + beta) in closed form, given
    `dapply`, the apply's gradients of mean, mul and beta ((C,) each), and
    `dse` (B, C), the SE input's: (dsums (2, C) times `scale`, dw, db, drows
    (B, C) or None). All f32; var_raw is E[y^2] - mean^2 before the clamp."""
    if mean.device.type == "cpu":
        return bn_moments_backward_reference(dapply, mean, mul, var_raw, w, rows, dse, eps=eps,
                                             scale=scale)
    C = mean.shape[0]
    f32 = torch.float32
    ops = [*zip(("dmean", "dmul", "dbeta"), dapply, [(C,)] * 3), ("mean", mean, (C,)),
           ("mul", mul, (C,)), ("var_raw", var_raw, (C,)), ("w", w, (C,))]
    if rows is not None:
        ops += [("rows", rows, rows.shape), ("dse", dse, rows.shape)]
    for name, t, shape in ops:
        if t is None or t.shape != shape or t.dtype != f32 or t.device != mean.device \
                or not t.is_contiguous():
            raise ValueError(f"{name}: expected a contiguous f32 {tuple(shape)} on {mean.device}")
    B = 1 if rows is None else rows.shape[0]
    lib = _build.load_library()
    dsums = torch.empty((2, C), dtype=f32, device=mean.device)
    dw, db = torch.empty_like(mean), torch.empty_like(mean)
    drows = None if rows is None else torch.empty_like(rows)
    err = lib.keisei_bn_moments_backward(*map(_ptr, dapply), mean.data_ptr(), mul.data_ptr(),
                                         var_raw.data_ptr(), w.data_ptr(), _ptr(rows), _ptr(dse),
                                         _ptr(drows), dsums.data_ptr(), dw.data_ptr(),
                                         db.data_ptr(), B, C, eps, scale, _stream(mean))
    _build.check(lib, err, "bn_moments_backward launch")
    bn_moments_backward.launches += 1
    return dsums, dw, db, drows


bn_moments_backward.launches = 0

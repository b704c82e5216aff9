"""The train path's kernels (ops/train_bn.py, csrc/train_bn.cu) on the card.

Each kernel against its plain version and, at the main path's shape (a
b40c256 minibatch: B=1,024, C=256, bf16), its time from a CUDA graph beside
its bound (bytes at 3.35 TB/s: each operand read once, each output written
once), the plain version's time and, as yardstick, cuDNN's F.batch_norm in
training mode (which the port never calls); then one block's and the whole
b40c256 model's train-mode forward + backward on the kernels and on the
plain path, with their peak memory.

    python -m keisei_tpu_torch.scripts.profile_train_bn [B] [C]
"""

from __future__ import annotations

import contextlib
import json
import sys

import torch
import torch.nn.functional as F

from ..models import se_resnet
from ..ops import train_bn as K
from ..utils.timing import cuda_ms, graph_ms

PEAK_BYTES = 3.35e12
WRAPPERS = (K.pool_stats, K.pool_stats_backward, K.bn_sums, K.bn_apply, K.bn_grad_sums,
            K.bn_grad_apply, K.bn_moments_backward)


def launch_counts() -> dict[str, int]:
    """Launches so far under each of cases()' names: a wrapper that takes a
    mode counts per mode."""
    out = {}
    for w in WRAPPERS:
        modes = getattr(w, "mode_launches", None)
        if modes is None:
            out[w.__name__] = w.launches
        else:
            out.update({f"{w.__name__}[{m}]": modes[m] for m in K.MODES})
    return out


def reset_launches() -> None:
    for w in WRAPPERS:
        w.launches = 0
        if hasattr(w, "mode_launches"):
            w.mode_launches.clear()


def operands(B: int, C: int, dtype: torch.dtype, dev, seed: int = 0) -> dict:
    """Inputs of every kernel at (B, C): y like a conv's output, x like a
    block's input (after a ReLU, with one channel of board 0 all zero, so its
    max ties 81 ways), statistics near y's own, the gp bias, the SE's output
    and upstream gradients."""
    gen = torch.Generator(device="cpu").manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen) * scale).to(dev)

    y = rnd(B, C, 9, 9).to(dtype)
    x = torch.relu(rnd(B, C, 9, 9)).to(dtype)
    x[0, 0] = 0
    yf = y.float()
    mean = yf.mean(dim=(0, 2, 3))
    var = ((yf - mean[None, :, None, None]) ** 2).mean(dim=(0, 2, 3))
    af = (mean, torch.rsqrt(var + 1e-5) * (1 + 0.1 * rnd(C)), 0.1 * rnd(C))
    t = {"y": y, "x": x, "af": af, "g": rnd(B, C, scale=0.1).to(dtype),
         "se": rnd(B, 2 * C).to(dtype), "grad": rnd(B, C, 9, 9).to(dtype),
         "add": rnd(B, C, 9, 9, scale=0.1).to(dtype), "dsums": rnd(2, C, scale=1e-3),
         "drow": rnd(B, C, scale=1e-3), "dpool": rnd(B, 3 * C, scale=0.1)}
    var_raw = var.clone()
    var_raw[0] = -1e-7  # a variance that rounded below 0: the clamp's gradient is 0
    t["moments"] = ((rnd(C), rnd(C), rnd(C)), af[0], af[1], var_raw, 1 + 0.1 * rnd(C),
                    yf.sum(dim=(2, 3)), rnd(B, C, scale=0.1))
    t["out_plain"] = K.bn_apply_reference("plain", y, af, relu=True)
    t["out_tail"] = K.bn_apply_reference("tail", y, af, x=x, se=t["se"])
    t["pool"] = K.pool_stats_reference(x)
    t["dres"] = K.bn_grad_sums_reference("tail", t["grad"], y, af, out=t["out_tail"],
                                         se=t["se"])[2]
    return t


def cases(t: dict) -> dict:
    """name -> (kernel call, plain call, bytes the call must move)."""
    y, x, af, gr = t["y"], t["x"], t["af"], t["grad"]
    B, C = y.shape[:2]
    e = y.element_size()
    act, row, bc, ch = y.numel() * e, B * C * e, 4 * B * C, 4 * C
    plain_g = dict(out=t["out_plain"], relu=True)
    tail_g = dict(out=t["out_tail"], se=t["se"])
    tail_a = dict(se=t["se"], drow=t["drow"])

    def pair(fn, ref, *args, **kw):
        return (lambda: fn(*args, **kw)), (lambda: ref(*args, **kw))

    return {
        "pool_stats": (*pair(K.pool_stats, K.pool_stats_reference, x), act + 3 * bc),
        "pool_stats_backward": (*pair(K.pool_stats_backward, K.pool_stats_backward_reference,
                                      x, t["pool"], t["dpool"], t["add"]), 3 * act + 6 * bc),
        "bn_sums": (*pair(K.bn_sums, K.bn_sums_reference, y, True), act + bc + 2 * ch),
        "bn_apply[plain]": (*pair(K.bn_apply, K.bn_apply_reference, "plain", y, af, relu=True),
                            2 * act + 3 * ch),
        "bn_apply[head]": (*pair(K.bn_apply, K.bn_apply_reference, "head", y, af, g=t["g"]),
                           2 * act + row + 3 * ch),
        "bn_apply[tail]": (*pair(K.bn_apply, K.bn_apply_reference, "tail", y, af, x=x,
                                 se=t["se"]), 3 * act + 2 * row + 3 * ch),
        "bn_grad_sums[plain]": (*pair(K.bn_grad_sums, K.bn_grad_sums_reference, "plain", gr, y,
                                      af, **plain_g), 3 * act + 6 * ch),
        "bn_grad_sums[head]": (*pair(K.bn_grad_sums, K.bn_grad_sums_reference, "head", gr, y,
                                     af), 2 * act + row + 6 * ch),
        "bn_grad_sums[tail]": (*pair(K.bn_grad_sums, K.bn_grad_sums_reference, "tail", gr, y,
                                     af, **tail_g), 4 * act + 4 * row + 6 * ch),
        "bn_grad_apply[plain]": (*pair(K.bn_grad_apply, K.bn_grad_apply_reference, "plain", gr,
                                       y, af, t["dsums"], **plain_g), 4 * act + 5 * ch),
        "bn_grad_apply[head]": (*pair(K.bn_grad_apply, K.bn_grad_apply_reference, "head", gr, y,
                                      af, t["dsums"]), 3 * act + 5 * ch),
        "bn_grad_apply[tail]": (*pair(K.bn_grad_apply, K.bn_grad_apply_reference, "tail",
                                      t["dres"], y, af, t["dsums"], **tail_a),
                                3 * act + 2 * row + bc + 5 * ch),
        "bn_moments_backward": (*pair(K.bn_moments_backward, K.bn_moments_backward_reference,
                                      *t["moments"], eps=1e-5, scale=1.0 / (81 * B)),
                                3 * bc + 11 * ch),
    }


def _tensors(r) -> list:
    return [r] if isinstance(r, torch.Tensor) else [v for v in r if v is not None]


def errors(got, ref) -> list[tuple[float, float]]:
    """Each output's (max |got - ref| / max |ref|, its bound): an output in
    bf16 may differ by a rounding, one in f32 only by the order of its sums."""
    out = []
    for a, b in zip(_tensors(got), _tensors(ref), strict=True):
        scale = float(b.float().abs().max())
        err = float((a.float() - b.float()).abs().max()) / max(scale, 1e-30)
        out.append((err, 1e-2 if b.dtype == torch.bfloat16 else 1e-3))
    return out


def check(B: int, C: int, dtype: torch.dtype, dev, seed: int = 0) -> dict[str, list[float]]:
    """Every kernel against its plain version at (B, C); raises past the bound."""
    t = operands(B, C, dtype, dev, seed)
    errs = {}
    for name, (fn, ref, _) in cases(t).items():
        got = errors(fn(), ref())
        for i, (e, tol) in enumerate(got):
            if not e <= tol:
                raise AssertionError(f"{name} B={B} C={C} {dtype}: output {i} off by {e:.3g}")
        errs[name] = [e for e, _ in got]
    torch.cuda.synchronize()
    return errs


def _library_ms(y: torch.Tensor) -> tuple[float, float]:
    """cuDNN's train-mode BatchNorm of y: forward, and backward alone."""
    C = y.shape[1]
    w = torch.ones(C, device=y.device, dtype=torch.float32, requires_grad=True)
    b = torch.zeros(C, device=y.device, dtype=torch.float32, requires_grad=True)
    yg = y.detach().requires_grad_()
    grad = torch.randn_like(y)

    def fwd():
        return F.batch_norm(yg, None, None, w, b, training=True, momentum=0.1, eps=1e-5)

    def both():
        torch.autograd.grad(fwd(), (yg, w, b), grad)

    f = cuda_ms(fwd, iters=50, warmup=5)
    return f, cuda_ms(both, iters=50, warmup=5) - f


def measure(dev, B: int = 1024, C: int = 256) -> dict[str, dict]:
    """Each kernel at (B, C) in bf16: ms, bound ms, plain ms, library ms."""
    t = operands(B, C, torch.bfloat16, dev, seed=1)
    lib_fwd, lib_bwd = _library_ms(t["y"])
    rows = {}
    for name, (fn, ref, nbytes) in cases(t).items():
        wrapper = next(w for w in WRAPPERS if w.__name__ == name.split("[")[0])
        counters = (wrapper, *(getattr(wrapper, "mode_launches", None),) * ("[" in name))
        rows[name] = {"ms": graph_ms(fn, iters=50, counters=counters),
                      "bound_ms": nbytes / PEAK_BYTES * 1e3, "bound_by": "bytes",
                      "plain_ms": graph_ms(ref, iters=10), "library_ms": None,
                      "max_rel_err": max(e for e, _ in errors(fn(), ref()))}
    rows["bn_apply[plain]"]["library_ms"] = lib_fwd
    rows["bn_grad_apply[plain]"]["library_ms"] = lib_bwd
    return rows


@contextlib.contextmanager
def plain_path():
    """The train path's written-out code on the card (the kernels' yardstick)."""
    keep = se_resnet._train_kernels
    se_resnet._train_kernels = lambda x: False
    try:
        yield
    finally:
        se_resnet._train_kernels = keep


def train_step_ms(module, x: torch.Tensor, fused: bool, iters: int) -> tuple[float, float]:
    """(ms, peak GB) of module(x)'s train-mode forward and backward under
    bf16 autocast, on the kernels or on the plain path."""
    module.train()

    def step():
        with torch.autocast(x.device.type, dtype=torch.bfloat16):
            out = module(x)
        outs = ([out] if isinstance(out, torch.Tensor)
                else [out.policy_logits, out.value_logits, out.score_lead])
        torch.autograd.backward(outs, [torch.ones_like(v) for v in outs])

    with contextlib.nullcontext() if fused else plain_path():
        step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(step, iters=iters, warmup=1)
    return ms, torch.cuda.max_memory_allocated() / 1e9


def steps(dev, B: int = 1024, C: int = 256) -> dict:
    """A block's and the b40c256 model's train step, fused and plain."""
    from ..models.registry import build_model
    torch.manual_seed(0)
    block = se_resnet.GlobalPoolBiasBlock(C, 16, 128).to(dev)
    x = torch.relu(torch.randn(B, C, 9, 9, device=dev)).to(torch.bfloat16).requires_grad_()
    got = {}
    for fused in (False, True, True, False):
        key = "fused" if fused else "plain"
        ms, gb = train_step_ms(block, x, fused, iters=20)
        got.setdefault(f"block_{key}_ms", []).append(ms)
        got[f"block_{key}_peak_gb"] = gb
    del block, x
    model = build_model("se_resnet", {"num_blocks": 40, "channels": C})[0].to(dev)
    obs = (torch.rand(B, 50, 9, 9, device=dev) > 0.8).float()
    for fused in (False, True, True, False):
        key = "fused" if fused else "plain"
        ms, gb = train_step_ms(model, obs, fused, iters=3)
        got.setdefault(f"model_{key}_ms", []).append(ms)
        got[f"model_{key}_peak_gb"] = gb
    return got


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    B = int(argv[0]) if argv else 1024
    C = int(argv[1]) if len(argv) > 1 else 256
    for dtype in (torch.float32, torch.bfloat16):
        for b, c in ((1, 32), (5, 50), (B, C)):
            errs = check(b, c, dtype, dev)
            print(f"check {dtype} B={b} C={c} worst={max(max(v) for v in errs.values()):.3g}")
    rows = measure(dev, B, C)
    for name, r in rows.items():
        print(f"{name} B={B} C={C} bf16 " + json.dumps({k: v for k, v in r.items()}))
    print("steps " + json.dumps(steps(dev, B, C)))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

"""Conv-algorithm alternatives for the SE-ResNet trunk on the card
(counterpart of scripts/profile_conv_alternatives.py, whose Pallas kernel
make_pallas_mm it replaces):

  a) the direct bf16 3x3 conv through cuDNN (F.conv2d, channels_last), in
     place of the TPU script's XLA conv, as an 80-conv chain at B=1024;
  b) Winograd F(2x2, 3x3) as plain torch ops (XLA ops in the TPU script, not
     a kernel): 25 tiles x 16 products per board against 81 x 9 taps;
  c) `tiled_mm(a, bt)`, a GEMM tiled over M and N (csrc/tiled_mm.cu), s8 ->
     s32 or bf16 -> f32, at the im2col conv shape (4096, 1152) @ (1152, 256),
     beside cuBLAS: torch._int_mm in int8 and torch.matmul in bf16 (which
     rounds its output to bf16, where tiled_mm writes f32).

The TPU script fed each GEMM's output back into its input (a + o.sum() % 3)
so that XLA could not hoist the call out of its scan; launches on the card
are not hoisted, so they are replayed back to back from a CUDA graph (a
20 us GEMM runs for less time than its launch from Python) and timed by
CUDA events.

`tiled_mm` takes b transposed, bt (N, K) [n][k], K-contiguous as the port's
int8 conv weights are; on CPU tensors it runs its plain version.
`tiled_mm.launches` counts launches per type.

    python -m keisei_tpu_torch.scripts.profile_conv_alternatives

prints the card's name and power limit, the Winograd check, the two chains
and the GEMM times and rates. Needs a CUDA device; exits non-zero without
one.
"""

from __future__ import annotations

import math
import sys
from collections import Counter

import torch
import torch.nn.functional as F

from ..ops import _build
from ..utils.timing import card, cuda_ms, graph_ms

B = 1024          # the rollout batch of the TPU script
C = 256           # flagship channels
BLOCKS = 80       # 40 blocks x 2 convs: the trunk's chain of convs
GM, GK, GN = 4096, 1152, 256   # im2col conv shape: (B_t * 81, 9 * C_in) x (., C_out)
TILE_M, TILE_N = 64, 128       # csrc/tiled_mm.cu's CTA tile

_G = torch.tensor([[1, 0, 0], [0.5, 0.5, 0.5], [0.5, -0.5, 0.5], [0, 0, 1]])


def _check_mm(a, bt) -> None:
    if a.dtype not in (torch.int8, torch.bfloat16) or bt.dtype != a.dtype:
        raise TypeError(f"a and bt must both be int8 or bfloat16, got {a.dtype} and {bt.dtype}")
    if a.dim() != 2 or bt.dim() != 2 or a.shape[1] != bt.shape[1]:
        raise ValueError(f"expected a (M, K) and bt (N, K), got {tuple(a.shape)} and "
                         f"{tuple(bt.shape)}")
    if bt.device != a.device:
        raise ValueError(f"bt on {bt.device} but a on {a.device}")


def tiled_mm_reference(a, bt) -> torch.Tensor:
    """Plain version: a @ bt^T, int32 from exact f64 sums (int8) or f32."""
    _check_mm(a, bt)
    if a.dtype == torch.int8:
        return (a.double() @ bt.double().t()).to(torch.int32)
    return a.float() @ bt.float().t()


def tiled_mm(a, bt) -> torch.Tensor:
    """a (M, K) @ bt (N, K)^T: int8 -> int32, bf16 -> f32. K must fill
    whole 128-byte slices (int8 K % 128, bf16 K % 64) and N % 8 == 0."""
    _check_mm(a, bt)
    if a.device.type == "cpu":
        return tiled_mm_reference(a, bt)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    (m, k), n = a.shape, bt.shape[0]
    if (k * a.element_size()) % 128 or n % 8:
        raise ValueError(f"tiled_mm needs K bytes % 128 == 0 and N % 8 == 0, got K={k} N={n}")
    if not (a.is_contiguous() and bt.is_contiguous()):
        raise ValueError("a and bt must be contiguous")
    lib = _build.load_library()
    bf16 = a.dtype == torch.bfloat16
    out = torch.empty((m, n), dtype=torch.float32 if bf16 else torch.int32, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = lib.keisei_tiled_mm(a.data_ptr(), bt.data_ptr(), out.data_ptr(), m, n, k, int(bf16),
                              stream)
    _build.check(lib, err, "tiled_mm launch")
    tiled_mm.launches["bf16" if bf16 else "int8"] += 1
    return out


tiled_mm.launches = Counter()


def mm_inputs(dtype: torch.dtype, m: int, k: int, n: int, device, seed: int = 0):
    """a (m, k), bt (n, k) from `seed`: int8 in [-127, 127], bf16 normals."""
    g = torch.Generator().manual_seed(seed)
    if dtype == torch.int8:
        return tuple(torch.randint(-127, 128, s, generator=g, dtype=torch.int8).to(device)
                     for s in ((m, k), (n, k)))
    return tuple(torch.randn(*s, generator=g).to(dtype).to(device) for s in ((m, k), (n, k)))


def wino2_weights(w: torch.Tensor) -> torch.Tensor:
    """(3, 3, Ci, Co) -> (16, Ci, Co) Winograd-domain kernel, bf16."""
    g = _G.to(w.device)
    wt = torch.einsum("ak,bl,klio->abio", g, g, w.float())
    return wt.reshape(16, w.shape[2], w.shape[3]).to(torch.bfloat16)


def _bt_apply(r):
    return [r[0] - r[2], r[1] + r[2], r[2] - r[1], r[1] - r[3]]


def _at_apply(r):
    return [r[0] + r[1] + r[2], r[1] - r[2] - r[3]]


def wino2_conv(x: torch.Tensor, wt: torch.Tensor) -> torch.Tensor:
    """x (B, 9, 9, Ci) bf16, wt (16, Ci, Co) bf16 -> (B, 9, 9, Co) bf16: the
    SAME 3x3 conv through 5 x 5 overlapping 4 x 4 tiles. The 16 tile GEMMs
    are one bf16 bmm (cuBLAS, bf16 out); the TPU script's dot returned f32."""
    n, ci = x.shape[0], x.shape[3]
    co = wt.shape[2]
    xp = F.pad(x, (0, 0, 1, 2, 1, 2))
    u = [[xp[:, i:i + 10:2, j:j + 10:2, :] for j in range(4)] for i in range(4)]
    tmp = [[None] * 4 for _ in range(4)]
    for j in range(4):
        t = _bt_apply([u[i][j] for i in range(4)])
        for a in range(4):
            tmp[a][j] = t[a]
    vab = []
    for a in range(4):
        vab += _bt_apply(tmp[a])
    v = torch.stack(vab).reshape(16, n * 25, ci)
    m = torch.bmm(v, wt).float().reshape(4, 4, n, 5, 5, co)
    tmp2 = [[None] * 4 for _ in range(2)]
    for b in range(4):
        t = _at_apply([m[a, b] for a in range(4)])
        for p in range(2):
            tmp2[p][b] = t[p]
    y = torch.stack([torch.stack(_at_apply(tmp2[p])) for p in range(2)])  # (2, 2, n, 5, 5, co)
    y = y.permute(2, 3, 0, 4, 1, 5).reshape(n, 10, 10, co)[:, :9, :9, :]
    return y.to(torch.bfloat16)


def chain_ms(conv, weights, x0, iters: int = 3) -> float:
    """ms of the trunk chain: x <- conv(x, w) * 0.5 over the weights."""
    def run():
        x = x0
        for w in weights:
            x = conv(x, w) * 0.5
        return x
    return cuda_ms(run, iters=iters, warmup=1)


def check(device) -> dict:
    """Winograd against the direct f32 conv (relative error, reported as
    the TPU script does), and tiled_mm against its plain version: exact in
    int8, within 1e-4 of the largest |value| in bf16 (f32 sums in another
    order, no rounding to bf16). Raises on a disagreement."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(8, 9, 9, 32, generator=g)
    w = torch.randn(3, 3, 32, 32, generator=g) * 0.1
    ref = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=1).permute(0, 2, 3, 1)
    wt = torch.einsum("ak,bl,klio->abio", _G, _G, w).reshape(16, 32, 32)
    got = wino2_conv(x.to(torch.bfloat16).to(device), wt.to(torch.bfloat16).to(device))
    res = {"winograd_rel_err": float((got.float().cpu() - ref).abs().max() / ref.abs().max())}
    for dtype, name in ((torch.int8, "int8"), (torch.bfloat16, "bf16")):
        a, bt = mm_inputs(dtype, 320, 384, 200, device)
        res[f"tiled_mm_{name}_max_abs_err"] = compare_mm(tiled_mm(a, bt), tiled_mm_reference(a, bt))
    return res


def compare_mm(got: torch.Tensor, ref: torch.Tensor) -> float:
    """tiled_mm's bound: equal in int8, within 1e-4 of max |ref| in bf16.
    Raises outside it; returns the max abs error."""
    err = float((got.double() - ref.double()).abs().max())
    exact = ref.dtype == torch.int32
    ok = torch.equal(got, ref) if exact else err <= 1e-4 * float(ref.abs().max())
    if not ok:
        raise AssertionError(f"tiled_mm {'int8' if exact else 'bf16'} disagrees with its plain "
                             f"version: max abs err {err}")
    return err


def measure(device, b: int = B, blocks: int = BLOCKS, iters: int = 3) -> dict:
    """The direct (cuDNN) and Winograd chains at (b, 256) over `blocks`
    weight sets, and tiled_mm beside cuBLAS at (GM, GK, GN)."""
    g = torch.Generator().manual_seed(0)
    ws = [torch.randn(3, 3, C, C, generator=g).to(torch.bfloat16) * 0.02 for _ in range(blocks)]
    res = {}
    w_cl = [w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last).to(device)
            for w in ws]
    x0 = torch.full((b, C, 9, 9), 0.01, dtype=torch.bfloat16,
                    device=device).contiguous(memory_format=torch.channels_last)
    res["direct_ms"] = chain_ms(lambda x, w: F.conv2d(x, w, padding=1), w_cl, x0, iters)
    del w_cl
    w_wino = [wino2_weights(w.to(device)) for w in ws]
    x0 = torch.full((b, 9, 9, C), 0.01, dtype=torch.bfloat16, device=device)
    res["winograd_ms"] = chain_ms(wino2_conv, w_wino, x0, iters)
    del w_wino
    res["direct_flop"] = 2.0 * 81 * 9 * b * C * C * blocks
    for dtype, name in ((torch.int8, "int8"), (torch.bfloat16, "bf16")):
        a, bt = mm_inputs(dtype, GM, GK, GN, device, seed=1)
        res[f"mm_{name}_ms"] = graph_ms(lambda: tiled_mm(a, bt), counters=(tiled_mm.launches,))
        if dtype == torch.int8:
            res[f"mm_{name}_library_ms"] = graph_ms(lambda: torch._int_mm(a, bt.t()))
        else:
            res[f"mm_{name}_library_ms"] = graph_ms(lambda: torch.matmul(a, bt.t()))
    res["mm_ops"] = 2.0 * GM * GK * GN
    res["mm_ctas"] = math.ceil(GM / TILE_M) * math.ceil(GN / TILE_N)
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_conv_alternatives: no CUDA device", file=sys.stderr)
        return 2
    print(card())
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    chk = check(dev)
    print(f"winograd-vs-direct rel err (bf16 pipeline): {chk['winograd_rel_err']:.4f}")
    r = measure(dev)
    print(f"direct bf16 conv (cuDNN) x{BLOCKS}, B={B}: {r['direct_ms']:.2f} ms "
          f"({r['direct_flop'] / r['direct_ms'] / 1e9:.1f} TFLOP/s)")
    print(f"winograd F(2,3) torch ops x{BLOCKS}, B={B}: {r['winograd_ms']:.2f} ms "
          f"(speedup vs direct: {r['direct_ms'] / r['winograd_ms']:.2f}x)")
    for name, unit, lib in (("bf16", "TFLOP/s", "torch.matmul, bf16 out"),
                            ("int8", "TOP/s", "torch._int_mm")):
        ms, lms = r[f"mm_{name}_ms"], r[f"mm_{name}_library_ms"]
        print(f"tiled_mm {name} {GM}x{GK}x{GN} ({r['mm_ctas']} CTAs of {TILE_M}x{TILE_N}): "
              f"{ms:.4f} ms ({r['mm_ops'] / ms / 1e9:.1f} {unit}); cuBLAS ({lib}) {lms:.4f} ms "
              f"({r['mm_ops'] / lms / 1e9:.1f} {unit})")
    return 0


if __name__ == "__main__":
    sys.exit(main())

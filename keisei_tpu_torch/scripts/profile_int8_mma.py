"""Tensor-core rate probe on the card: s8 -> s32 and bf16 -> f32 mma.sync
(counterpart of scripts/profile_int8_mxu.py:make, whose Pallas kernel it
replaces).

`mma_chain(a, b, chain)` runs csrc/mma_rate.cu: every CTA keeps 128 rows of
X and the whole (256, 256) B in shared memory and computes a chain of
dependent products X <- (X @ B^T) mod 2. The rate it reaches is the
practical ceiling of the structure the port's kernels share (mma.sync fed
by ldmatrix from swizzled shared memory), against which their times are
read. On a CPU tensor `mma_chain` runs the plain version.

    python -m keisei_tpu_torch.scripts.profile_int8_mma

prints the card's name and power limit, then one line per type with ms per
launch, TOP/s (int8) or TFLOP/s (bf16) and the share of the card's dense
peak. Needs a CUDA device; exits non-zero without one.
"""

from __future__ import annotations

import sys

import torch

from ..ops import _build
from ..utils.timing import card, cuda_ms

K = 256             # B is (K, K); X rows are K wide
ROWS = 128          # rows of X per CTA
M = ROWS * 132 * 2  # two CTAs' worth of rows per SM of an H100
CHAIN = 64          # dependent products per launch
PEAK = {torch.int8: 1979e12, torch.bfloat16: 989e12}   # H100 SXM dense, ops/s


def _check(a: torch.Tensor, b: torch.Tensor, chain: int) -> None:
    if a.dtype not in PEAK or b.dtype != a.dtype:
        raise TypeError(f"a and b must both be int8 or bfloat16, got {a.dtype} and {b.dtype}")
    if a.dim() != 2 or a.shape[1] != K or a.shape[0] % ROWS or tuple(b.shape) != (K, K):
        raise ValueError(f"expected a (M, {K}) with M a multiple of {ROWS} and b ({K}, {K}), "
                         f"got {tuple(a.shape)} and {tuple(b.shape)}")
    if chain < 1:
        raise ValueError(f"chain must be >= 1, got {chain}")


def mma_chain_reference(a: torch.Tensor, b: torch.Tensor, chain: int) -> torch.Tensor:
    """Plain version: X <- (X @ b^T) mod 2, `chain` times, in exact f64."""
    _check(a, b, chain)
    x, bd = a.double(), b.double()
    for _ in range(chain):
        x = torch.bitwise_and((x @ bd.t()).long(), 1).double()
    return x.to(a.dtype)


def mma_chain(a: torch.Tensor, b: torch.Tensor, chain: int) -> torch.Tensor:
    """a (M, 256), b (256, 256) [n][k], both int8 or both bf16 -> X_chain of
    X_0 = a, X_{i+1} = (X_i @ b^T) mod 2, in a's type."""
    _check(a, b, chain)
    if a.device.type == "cpu":
        return mma_chain_reference(a, b, chain)
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"unsupported devices {a.device}, {b.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("a and b must be contiguous")
    lib = _build.load_library()
    out = torch.empty_like(a)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    err = lib.keisei_mma_rate(a.data_ptr(), b.data_ptr(), out.data_ptr(), a.shape[0], chain,
                              int(a.dtype == torch.bfloat16), stream)
    _build.check(lib, err, "mma_rate launch")
    mma_chain.launches += 1
    return out


mma_chain.launches = 0


def probe_inputs(dtype: torch.dtype, rows: int, device, seed: int = 0):
    """X_0 in {0, 1} and B in {-1, 0, 1}, made from `seed`."""
    g = torch.Generator().manual_seed(seed)
    a = torch.randint(0, 2, (rows, K), generator=g)
    b = torch.randint(-1, 2, (K, K), generator=g)
    return a.to(dtype).to(device), b.to(dtype).to(device)


def check(device: torch.device, chain: int = 3) -> None:
    """The kernel against its plain version on a small input; both types."""
    for dtype in PEAK:
        a, b = probe_inputs(dtype, 2 * ROWS, device)
        if not torch.equal(mma_chain(a, b, chain), mma_chain_reference(a, b, chain)):
            raise AssertionError(f"mma_chain {dtype} disagrees with its plain version")


def measure(device: torch.device) -> dict:
    """Time the kernel at (M, CHAIN): per type, ms per launch, the
    operations of one launch, the rate and its share of the dense peak."""
    results = {}
    for dtype, name in ((torch.int8, "int8"), (torch.bfloat16, "bf16")):
        a, b = probe_inputs(dtype, M, device, seed=1)
        ms = cuda_ms(lambda: mma_chain(a, b, CHAIN))
        ops = 2.0 * M * K * K * CHAIN
        results[name] = {"ms": ms, "ops": ops, "rate": ops / (ms * 1e-3),
                         "peak_share": ops / (ms * 1e-3) / PEAK[dtype]}
    return results


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_int8_mma: no CUDA device", file=sys.stderr)
        return 2
    print(card())
    dev = torch.device("cuda")
    check(dev)
    res = measure(dev)
    for name, unit in (("int8", "TOP/s"), ("bf16", "TFLOP/s")):
        r = res[name]
        print(f"mma.sync {name} ({M}x{K})@({K}x{K}) x{CHAIN} in shared memory: "
              f"{r['ms']:.4f} ms/launch -> {r['rate'] / 1e12:.1f} {unit} "
              f"({100 * r['peak_share']:.1f}% of dense peak)")
    return 0


if __name__ == "__main__":
    sys.exit(main())

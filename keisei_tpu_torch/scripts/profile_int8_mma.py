"""Tensor-core rate probe on the card, s8 -> s32 and bf16 -> f32 wgmma
(counterpart of scripts/profile_int8_mxu.py:make, whose Pallas kernel it
replaces). It measures the rate of a chain of dependent products, which the
exchange of X between a cluster's CTAs bounds (PERF.md, section 6), not the
card's wgmma ceiling: the port's convs run faster than it.

`mma_chain(a, b, chain)` computes the TPU kernel's function: X_0 = a,
X_{i+1} = (X_i @ B) & 1 in int8 (s32 sums) or bf16(f32(X_i @ B) * 1e-3) in
bf16, with b = B^T ([n][k], K-contiguous). On the card it runs
csrc/chain_wgmma.cu (ops/gemm_chain.py): a cluster of CTAs along N shares a
tile of rows, each CTA keeps its slice of B resident in shared memory, and
after every product the CTAs hand each other their columns of X through
L2. On a CPU tensor it runs the plain version, at any K that is a multiple
of 64.

    python -m keisei_tpu_torch.scripts.profile_int8_mma

prints the card's name and power limit, then one line per type at the TPU
script's K = 512 and 32 products per launch: ms per launch, TOP/s (int8) or
TFLOP/s (bf16), the share of the card's dense peak, the CTAs of a launch,
and how many clusters the card holds at once. Needs a CUDA device; exits
non-zero without one.
"""

from __future__ import annotations

import math
import sys
from collections import Counter

import torch

from ..ops.gemm_chain import (chain_plan, check_chain, ctas, gemm_chain, gemm_chain_reference,
                              hold_to_plain, max_active_clusters, type_key)
from ..utils.timing import card, cuda_ms

K = 512               # B is (K, K); X rows are K wide (the TPU script's K)
CHAIN = 32            # dependent products per launch (the TPU script's CHAIN)
M = 33_792            # 4 waves of 66 int8 clusters (128 rows), 16 of 33 bf16 ones (64 rows)
PEAK = {torch.int8: 1979e12, torch.bfloat16: 989e12}   # H100 SXM dense, ops/s


def mma_chain_reference(a: torch.Tensor, b: torch.Tensor, chain: int) -> torch.Tensor:
    """Plain version: X <- (X @ b^T) & 1 in exact f64 (int8), X <-
    bf16(f32(X @ b^T) * 1e-3) (bf16), `chain` times."""
    return gemm_chain_reference(a, b, chain)


def mma_chain(a: torch.Tensor, b: torch.Tensor, chain: int) -> torch.Tensor:
    """a (M, K), b (K, K) [n][k] (B^T), both int8 or both bf16 -> X_chain of
    X_0 = a, X_{i+1} = (X_i @ b^T) & 1 (int8) or bf16((X_i @ b^T) * 1e-3)
    (bf16), in a's type. The card takes K = 512 or 768."""
    check_chain(a, b, chain)
    out = gemm_chain(a, b, chain)
    if a.device.type == "cuda":
        mma_chain.launches[type_key(a.dtype)] += 1
    return out


mma_chain.launches = Counter()


def probe_inputs(dtype: torch.dtype, rows: int, device, seed: int = 0, k: int = K):
    """X_0 (rows, k) and B^T (k, k), made from `seed`: int8 X in {0, 1} and
    B in {-1, 0, 1}; bf16 normals with B scaled by 1e3 / sqrt(k), so that
    |X| stays of order one along the chain."""
    g = torch.Generator().manual_seed(seed)
    if dtype == torch.int8:
        a = torch.randint(0, 2, (rows, k), generator=g)
        b = torch.randint(-1, 2, (k, k), generator=g)
    else:
        a = torch.randn(rows, k, generator=g)
        b = torch.randn(k, k, generator=g) * (1e3 / math.sqrt(k))
    return a.to(dtype).to(device), b.to(dtype).to(device)


def check(device: torch.device, chain: int = 3) -> dict[str, dict]:
    """The kernel against its plain version (ops/gemm_chain.py:hold_to_plain),
    both types, at K = 512 with a partial last tile; the errors per type."""
    errs = {}
    for dtype in PEAK:
        a, b = probe_inputs(dtype, 3 * chain_plan(dtype, K).rows + 40, device)
        errs[type_key(dtype)] = hold_to_plain(mma_chain, a, b, chain)
    return errs


def measure(device: torch.device) -> dict:
    """Time the kernel at (M, K, CHAIN): per type, ms per launch, the
    operations of one launch, the rate and its share of the dense peak, the
    CTAs of a launch and the clusters the card holds at once."""
    results = {}
    for dtype in PEAK:
        a, b = probe_inputs(dtype, M, device, seed=1)
        ms = cuda_ms(lambda: mma_chain(a, b, CHAIN))
        ops = 2.0 * M * K * K * CHAIN
        results[type_key(dtype)] = {
            "ms": ms, "ops": ops, "rate": ops / (ms * 1e-3),
            "peak_share": ops / (ms * 1e-3) / PEAK[dtype], "ctas": ctas(M, dtype, K),
            "cluster": chain_plan(dtype, K), "max_clusters": max_active_clusters(dtype, K)}
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
        plan = r["cluster"]
        print(f"wgmma {name} ({M}x{K})@({K}x{K}) x{CHAIN}, clusters of {plan.cn} x {plan.rows} "
              f"rows, {r['ctas']} CTAs, {r['max_clusters']} clusters at once: "
              f"{r['ms']:.4f} ms/launch -> {r['rate'] / 1e12:.1f} {unit} "
              f"({100 * r['peak_share']:.1f}% of dense peak)")
    return 0


if __name__ == "__main__":
    sys.exit(main())

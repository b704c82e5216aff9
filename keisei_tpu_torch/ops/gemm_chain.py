"""A chain of dependent square products, X_{i+1} = f(X_i @ W), on the card
(csrc/chain_wgmma.cu) and as its plain version.

    int8: f(s) = s & 1 of the exact s32 sums
    bf16: f(s) = bf16(s * 1e-3) of the f32 sums (one rounding)

W is given as W^T (`wt`, [n][k], K-contiguous). It is the function of two
TPU probes: scripts/profile_int8_mxu.py:make (the matrix-unit rate, K = 512)
and scripts/profile_qblock_parts.py:make_dotrate (K = 768). Their wrappers
(scripts/profile_int8_mma.py:mma_chain, scripts/profile_qblock_parts.py:
dot_chain) check their own shapes, count their own launches and call
`gemm_chain` here. On CPU tensors `gemm_chain` runs the plain version at any
K that is a multiple of 64; on the card it launches the kernel for the
(type, K) pairs of PLANS and raises on any other.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _build

DTYPES = (torch.int8, torch.bfloat16)


class ChainPlan(NamedTuple):
    """How csrc/chain_wgmma.cu cuts one (type, K): a cluster of `cn` CTAs
    along N shares a tile of `rows` rows (64 per consumer warpgroup), each
    CTA owning K / cn output columns; its W slice stays resident in shared
    memory (`stages` 0) or streams through a TMA ring `stages` deep. How the
    CTAs hand each other their columns of X_{i+1} is the kernel's own choice
    (csrc/chain_wgmma.cu, Cfg::EX)."""
    cn: int
    rows: int
    stages: int


PLANS = {(torch.int8, 512): ChainPlan(2, 128, 0),
         (torch.bfloat16, 512): ChainPlan(4, 64, 0),
         (torch.int8, 768): ChainPlan(4, 64, 0),
         (torch.bfloat16, 768): ChainPlan(4, 64, 5)}


def type_key(dtype: torch.dtype) -> str:
    return "bf16" if dtype == torch.bfloat16 else "int8"


def chain_plan(dtype: torch.dtype, k: int) -> ChainPlan:
    """The kernel's cut for (dtype, K); ValueError for a pair it does not take."""
    if (dtype, k) not in PLANS:
        raise ValueError(f"the CUDA chain takes (type, K) in "
                         f"{[(type_key(d), kk) for d, kk in PLANS]}, got ({type_key(dtype)}, {k})")
    return PLANS[(dtype, k)]


def ctas(m: int, dtype: torch.dtype, k: int) -> int:
    """CTAs of one launch at M = m rows."""
    plan = chain_plan(dtype, k)
    return -(-m // plan.rows) * plan.cn


def w_l2_bytes(m: int, dtype: torch.dtype, k: int, chain: int) -> int:
    """Bytes of W the kernel reads from L2 per launch, by its design: a
    resident slice once per CTA (W once per cluster), a streamed one once
    per CTA and step."""
    plan = chain_plan(dtype, k)
    slice_bytes = k * (k // plan.cn) * (2 if dtype == torch.bfloat16 else 1)
    return ctas(m, dtype, k) * slice_bytes * (chain if plan.stages else 1)


def check_chain(x: torch.Tensor, wt: torch.Tensor, chain: int) -> None:
    if x.dtype not in DTYPES or wt.dtype != x.dtype:
        raise TypeError(f"x and wt must both be int8 or bfloat16, got {x.dtype} and {wt.dtype}")
    if x.dim() != 2 or x.shape[1] % 64 or tuple(wt.shape) != (x.shape[1], x.shape[1]):
        raise ValueError(f"expected x (M, K) with K a multiple of 64 and wt (K, K), "
                         f"got {tuple(x.shape)} and {tuple(wt.shape)}")
    if wt.device != x.device:
        raise ValueError(f"wt on {wt.device} but x on {x.device}")
    if chain < 1:
        raise ValueError(f"chain must be >= 1, got {chain}")


def gemm_chain_reference(x: torch.Tensor, wt: torch.Tensor, chain: int) -> torch.Tensor:
    """Plain version: int8 X <- (X @ wt^T) & 1 in exact f64; bf16 X <-
    bf16(f32(X @ wt^T) * 1e-3)."""
    check_chain(x, wt, chain)
    if x.dtype == torch.int8:
        xd, wd = x.double(), wt.double()
        for _ in range(chain):
            xd = torch.bitwise_and((xd @ wd.t()).long(), 1).double()
        return xd.to(torch.int8)
    wf = wt.float()
    for _ in range(chain):
        x = ((x.float() @ wf.t()) * 1e-3).to(torch.bfloat16)
    return x


# bf16 chains up to this long are held whole to the plain version; a longer
# one step by step (hold_to_plain)
WHOLE_BF16 = 8
TOL = 0.05


def hold_to_plain(fn, x: torch.Tensor, wt: torch.Tensor, chain: int) -> dict[str, float]:
    """Hold fn(x, wt, chain) (a wrapper of the kernel) to the plain version
    with the card-test bound: int8 equal; bf16 within rtol = atol = TOL, the
    whole chain up to WHOLE_BF16 steps, and a longer one step by step: for
    every n, fn(x, wt, n) against one plain step from fn(x, wt, n - 1)
    (fn(x, wt, 0) = x). Two summation orders differ by an ulp here and there
    in every step, and a chain whose map keeps |X| of order one carries those
    differences on and adds new ones, so over 32 steps they outgrow TOL in a
    few elements while every single step is within it. That holds the
    kernel to the plain version only if fn(x, wt, n) passes through the same
    X_{n-1} as fn(x, wt, n - 1) returns: each launch sums in a fixed order,
    so one launch of a step from fn(x, wt, n - 1) must give fn(x, wt, n)'s
    bits, and that is checked at every n too. Returns the whole chain's max
    |error| and, for a long bf16 chain, the largest single step's
    ("step_err"). Raises outside the bound."""
    got = fn(x, wt, chain)
    ref = gemm_chain_reference(x, wt, chain)
    res = {"max_abs_err": float((got.float() - ref.float()).abs().max())}
    if x.dtype == torch.int8:
        if not torch.equal(got, ref):
            raise AssertionError(f"int8 chain of {chain} differs from its plain version: {res}")
        return res
    if chain <= WHOLE_BF16:
        if not torch.allclose(got.float(), ref.float(), rtol=TOL, atol=TOL):
            raise AssertionError(f"bf16 chain of {chain} disagrees with its plain version: {res}")
        return res
    prev, step_err = x, 0.0
    for n in range(1, chain + 1):
        y = got if n == chain else fn(x, wt, n)
        r = gemm_chain_reference(prev, wt, 1)
        step_err = max(step_err, float((y.float() - r.float()).abs().max()))
        if not torch.allclose(y.float(), r.float(), rtol=TOL, atol=TOL):
            raise AssertionError(f"step {n} of a bf16 chain of {chain} disagrees with one plain "
                                 f"step from step {n - 1}: max_abs_err {step_err}")
        if not torch.equal(fn(prev, wt, 1), y):
            raise AssertionError(f"step {n} of a bf16 chain of {chain} differs from one launch "
                                 f"of a step from step {n - 1}: the chain's prefix is not the "
                                 "shorter chain's")
        prev = y
    return {**res, "step_err": step_err}


def gemm_chain(x: torch.Tensor, wt: torch.Tensor, chain: int) -> torch.Tensor:
    """x (M, K), wt (K, K) [n][k], both int8 or both bf16 -> X_chain of X_0 =
    x, X_{i+1} = f(X_i @ wt^T), in x's type."""
    check_chain(x, wt, chain)
    if x.device.type == "cpu":
        return gemm_chain_reference(x, wt, chain)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    chain_plan(x.dtype, x.shape[1])
    if not (x.is_contiguous() and wt.is_contiguous()):
        raise ValueError("x and wt must be contiguous")
    lib = _build.load_library()
    out = torch.empty_like(x)
    # X between the cluster's CTAs, for the configurations that exchange through L2
    scratch = torch.empty((2,) + tuple(x.shape), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.keisei_gemm_chain(x.data_ptr(), wt.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                                x.shape[0], x.shape[1], chain, int(x.dtype == torch.bfloat16),
                                stream)
    _build.check(lib, err, "gemm_chain launch")
    return out


def max_active_clusters(dtype: torch.dtype, k: int) -> int:
    """How many clusters of the (dtype, K) kernel the card runs at once."""
    chain_plan(dtype, k)
    lib = _build.load_library()
    n = ctypes.c_int(0)
    _build.check(lib, lib.keisei_gemm_chain_clusters(k, int(dtype == torch.bfloat16),
                                                    ctypes.byref(n)),
                 "gemm_chain occupancy")
    return n.value

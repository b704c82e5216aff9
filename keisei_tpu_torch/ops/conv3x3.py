"""SAME 3x3 convolution in the (9, 9, B, C) layout (counterpart of
keisei_tpu/ops/conv3x3.py:conv3x3_hwbc, whose Pallas kernel it replaces).

On a CUDA tensor `conv3x3_hwbc` launches a hand-written sm_90a kernel or
raises; only a CPU tensor takes the plain PyTorch version,
`conv3x3_hwbc_reference`, which does the same nine f32 tap GEMMs. Which
kernel is a pure function of the shapes, `conv_route`:

- Cout 128 or 256 and Cin a multiple of 64 (the trunk's convs, and the
  fused forward's input conv, which keeps its planes padded to 64): the
  wgmma kernel fed by TMA (csrc/conv3x3_wgmma.cu), whose CTA computes 64 or
  128 boards at one output square ("wgmma");
- Cout 128 or 256 and any other Cin (the 50 observation planes, whose
  100-byte rows TMA cannot address): x and w are padded with zero channels to
  the next multiple of 64, two small copies, and take the same kernel
  ("wgmma_padded"). Zero channels add nothing to an f32 sum, so the function
  is the same;
- any other Cout: no kernel takes it; `conv_route` raises ValueError.

`conv3x3_hwbc.launches` counts kernel launches, `conv3x3_hwbc.route_launches`
the same launches per route.

`conv3x3_bpc` is the same conv with a chosen number of boards per CTA
(counterpart of scripts/profile_pallas_conv.py:pallas_conv, whose grid step
holds b_t boards): 1, 2 or 4 boards through the mma.sync kernel of
csrc/conv3x3.cu (every weight slice read from L2 serves that many boards),
64 or 128 through the wgmma kernel (the tile's height).
`conv3x3_bpc.launches` counts launches per boards-per-CTA.
"""

from __future__ import annotations

from collections import Counter
from typing import NamedTuple

import torch
import torch.nn.functional as F

from . import _build

__all__ = ["conv3x3_hwbc", "conv3x3_hwbc_reference", "conv3x3_bpc", "conv_route", "ConvRoute",
           "pad_channels", "padded_channels", "BOARDS_PER_CTA", "WGMMA_BOARDS"]

SUPPORTED_COUT = (128, 256)
WGMMA_BOARDS = (64, 128)                 # the wgmma kernel's tile heights
BOARDS_PER_CTA = (1, 2, 4, *WGMMA_BOARDS)


class ConvRoute(NamedTuple):
    """The kernel a conv of some shape takes, and its CTA tile."""
    # "wgmma", "wgmma_padded" (after a zero pad of Cin to 64s); conv3x3_bpc also "mma_sync"
    kernel: str
    boards: int        # boards per CTA
    cout_tile: int     # output channels per CTA
    persistent: bool   # one CTA per SM slot walking the tiles (wgmma only)


def wgmma_tile(n: int, cout: int, boards: int | None = None) -> ConvRoute:
    """The wgmma kernel's tile for n boards and cout output channels, with
    the tile's height fixed to `boards` or chosen from n.

    A CTA covers all of cout (128 or 256): splitting 256 channels over two
    CTAs reads every activation box twice and was slower at every B
    measured (scripts/profile_direct_conv.py's sweep on an H100: 0.0170
    against 0.0150 ms at B=64, 0.183 against 0.132 ms at B=1024). The
    height follows the count of tiles against the card's 132 SMs: 64 boards
    while 81 * ceil(n / 64) tiles are few waves (B=64: 81 CTAs where 128
    rows give 41; B=256: 324 tiles of 64 x 256 took 0.042 ms, 162 of 128 x
    256 took 0.049), 128 boards (two consumer warpgroups sharing each weight
    stage) once n > 512, where the waves' tails no longer matter (B=1024:
    0.126 against 0.146 ms). Cout=128 has half the work per tile and moves
    to 128 rows at n > 128. The grid is always persistent (one CTA per SM
    slot walking the tiles): 3-6% faster where tiles outnumber the SMs and
    the same launch where they do not."""
    if boards is None:
        boards = 128 if n > (512 if cout > 128 else 128) else 64
    return ConvRoute("wgmma", boards, cout, True)


def conv_route(n: int, cin: int, cout: int) -> ConvRoute:
    """Which kernel conv3x3_hwbc launches for x (9, 9, n, cin) and w (3, 3,
    cin, cout) on the card: a function of the shapes alone. Raises for a
    Cout no kernel takes."""
    if cout not in SUPPORTED_COUT:
        raise ValueError(f"CUDA conv3x3 takes Cout in {SUPPORTED_COUT}, got Cout={cout}")
    tile = wgmma_tile(n, cout)
    return tile if cin % 64 == 0 else tile._replace(kernel="wgmma_padded")


def padded_channels(c: int) -> int:
    """c rounded up to the wgmma kernel's K chunk of 64 channels."""
    return -(-c // 64) * 64


def pad_channels(t: torch.Tensor, dim: int) -> torch.Tensor:
    """t with zeros appended along `dim` up to padded_channels (a copy)."""
    pad = [0, 0] * (t.dim() - 1 - dim) + [0, padded_channels(t.shape[dim]) - t.shape[dim]]
    return F.pad(t, pad)


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 4 or tuple(x.shape[:2]) != (9, 9):
        raise ValueError(f"expected x (9, 9, B, Cin), got {tuple(x.shape)}")
    if w.dim() != 4 or tuple(w.shape[:2]) != (3, 3) or w.shape[2] != x.shape[3]:
        raise ValueError(f"kernel/activation mismatch: {tuple(w.shape)} vs {tuple(x.shape)}")
    if x.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise TypeError(f"x and w must be bfloat16, got {x.dtype} and {w.dtype}")
    if x.device != w.device:
        raise ValueError(f"x on {x.device} but w on {w.device}")


def conv3x3_taps_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Nine (81*B, Cin) @ (Cin, Cout) tap GEMMs in float32 on a zero-padded
    (11, 11, B, Cin) copy -> the f32 sum, (9, 9, B, Cout)."""
    n, cin = x.shape[2], x.shape[3]
    xp = F.pad(x.float(), (0, 0, 0, 0, 1, 1, 1, 1))
    wf = w.float()
    acc = torch.zeros((81 * n, w.shape[3]), dtype=torch.float32, device=x.device)
    for di in range(3):
        for dj in range(3):
            acc += xp[di:di + 9, dj:dj + 9].reshape(81 * n, cin) @ wf[di, dj]
    return acc.reshape(9, 9, n, -1)


def conv3x3_hwbc_reference(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version: the f32 tap sum, one bf16 rounding at the end."""
    _check(x, w)
    return conv3x3_taps_f32(x, w).to(torch.bfloat16)


def _launch_checks(x: torch.Tensor, w: torch.Tensor) -> tuple[int, int, int]:
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("x and w must be contiguous")
    return x.shape[2], x.shape[3], w.shape[3]


def _conv_mma_sync(x: torch.Tensor, w: torch.Tensor, boards_per_cta: int) -> torch.Tensor:
    """Launch csrc/conv3x3.cu's kernel for boards_per_cta boards per CTA."""
    n, cin, cout = _launch_checks(x, w)
    if cout not in SUPPORTED_COUT or cin > 256:
        raise ValueError(f"CUDA conv3x3 takes Cout in {SUPPORTED_COUT} and Cin <= 256, "
                         f"got Cin={cin} Cout={cout}")
    lib = _build.load_library()
    out = torch.empty((9, 9, n, cout), dtype=torch.bfloat16, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.keisei_conv3x3_bpc(x.data_ptr(), w.data_ptr(), out.data_ptr(), n, cin, cout,
                                 boards_per_cta, stream)
    _build.check(lib, err, f"conv3x3 ({boards_per_cta} boards per CTA) launch")
    return out


def _conv_wgmma(x: torch.Tensor, w: torch.Tensor, route: ConvRoute) -> torch.Tensor:
    """Launch csrc/conv3x3_wgmma.cu's kernel with the route's tile."""
    n, cin, cout = _launch_checks(x, w)
    if cin % 64 or cout % route.cout_tile:
        raise ValueError(f"the wgmma conv3x3 takes Cin % 64 == 0 and Cout % {route.cout_tile} "
                         f"== 0, got Cin={cin} Cout={cout}")
    lib = _build.load_library()
    out = torch.empty((9, 9, n, cout), dtype=torch.bfloat16, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.keisei_conv3x3_wgmma(x.data_ptr(), w.data_ptr(), out.data_ptr(), n, cin, cout,
                                   route.boards, route.cout_tile, int(route.persistent), stream)
    _build.check(lib, err, f"conv3x3 wgmma ({route.boards} x {route.cout_tile} tile) launch")
    return out


def _launch(x: torch.Tensor, w: torch.Tensor, route: ConvRoute) -> torch.Tensor:
    if route.kernel == "wgmma":
        return _conv_wgmma(x, w, route)
    if route.kernel == "wgmma_padded":
        _launch_checks(x, w)
        return _conv_wgmma(pad_channels(x, 3), pad_channels(w, 2), route)
    return _conv_mma_sync(x, w, route.boards)


def conv3x3_hwbc(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """SAME 3x3 conv: x (9, 9, B, Cin) bf16, w (3, 3, Cin, Cout) bf16 ->
    (9, 9, B, Cout) bf16, f32 accumulation."""
    _check(x, w)
    if x.device.type == "cpu":
        return conv3x3_hwbc_reference(x, w)
    route = conv_route(x.shape[2], x.shape[3], w.shape[3])
    out = _launch(x, w, route)
    conv3x3_hwbc.launches += 1
    conv3x3_hwbc.route_launches[route.kernel] += 1
    return out


conv3x3_hwbc.launches = 0
conv3x3_hwbc.route_launches = Counter()


def conv3x3_bpc(x: torch.Tensor, w: torch.Tensor, *, boards_per_cta: int) -> torch.Tensor:
    """conv3x3_hwbc's function with `boards_per_cta` boards per CTA (one of
    BOARDS_PER_CTA: 64 and 128 need Cin % 64 == 0); the plain version is
    conv3x3_hwbc_reference."""
    _check(x, w)
    if boards_per_cta not in BOARDS_PER_CTA:
        raise ValueError(f"boards_per_cta must be one of {BOARDS_PER_CTA}, got {boards_per_cta}")
    if x.device.type == "cpu":
        return conv3x3_hwbc_reference(x, w)
    if boards_per_cta in WGMMA_BOARDS:
        route = wgmma_tile(x.shape[2], w.shape[3], boards_per_cta)
    else:
        route = ConvRoute("mma_sync", boards_per_cta, w.shape[3], False)
    out = _launch(x, w, route)
    conv3x3_bpc.launches[boards_per_cta] += 1
    return out


conv3x3_bpc.launches = Counter()

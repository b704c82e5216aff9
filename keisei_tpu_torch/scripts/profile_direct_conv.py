"""The direct 3x3 conv per boards-per-CTA on the card, against cuDNN
(counterpart of scripts/profile_pallas_conv.py, whose Pallas kernel
pallas_conv it replaces: there a grid step holds b_t boards, here a CTA
holds boards_per_cta boards). 1, 2 and 4 boards per CTA are the mma.sync
kernel (every weight slice it reads from L2 serves that many boards); 64 and
128 are the wgmma kernel fed by TMA, whose CTA computes that many boards at
one output square.

    python -m keisei_tpu_torch.scripts.profile_direct_conv

prints the card's name and power limit; the check of each boards-per-CTA
kernel against the plain version at B=8 and B=7 (relative error, as the TPU
script checks its kernel against XLA's conv) and on one-hot boards with a
distinct weight per tap (equal: a transposed tap or a wrong zero-fill edge
shows as a wrong square); one conv at B = 64, 256, 512, 1024 (C=256) through
every tile of the wgmma kernel, one CTA per tile and persistent, beside the
mma.sync kernel and cuDNN (ms from CUDA-graph replays); then, at B = 256 and
B = 1024, an 80-conv chain (x <- conv(x, w) * 0.5, 80 distinct weights,
C=256) per boards-per-CTA, through conv3x3_hwbc (the kernel and tile its
route picks) and through cuDNN (F.conv2d, bf16, channels_last) in place of
the TPU script's XLA conv: ms per chain, TFLOP/s and the ratio to cuDNN.
Needs a CUDA device; exits non-zero without one.
"""

from __future__ import annotations

import sys

import torch
import torch.nn.functional as F

from ..ops import conv3x3 as ops
from ..ops.conv3x3 import (BOARDS_PER_CTA, ConvRoute, conv3x3_bpc, conv3x3_hwbc,
                           conv3x3_hwbc_reference, conv_route)
from ..utils.timing import card, graph_ms
from .profile_conv_alternatives import chain_ms

B = 1024
C = 256
BLOCKS = 80
CHECK_B = 8
CHAIN_BS = (256, B)
SWEEP_BS = (64, 256, 512, B)
WGMMA_TILES = ((64, 128), (64, 256), (128, 128), (128, 256))   # boards x output channels
ONE_HOT_SQUARES = {"corner": (0, 0), "edge": (0, 4), "centre": (4, 4), "far_corner": (8, 8)}


def one_hot_inputs(square: tuple[int, int], n: int = 5, board: int = 2, cin: int = 64,
                   cout: int = 128, channel: int | None = None):
    """x (9, 9, n, cin) with a single 1 at (square, board, channel) and w (3,
    3, cin, cout) whose every tap holds its own small integers (exact in
    bf16): the conv's output at board `board` is then w's taps laid around
    the square, out[i', j', board, o] = w[i - i' + 1, j - j' + 1, channel,
    o], and zero elsewhere, with no rounding anywhere."""
    channel = cin - 1 if channel is None else channel
    x = torch.zeros(9, 9, n, cin)
    x[square[0], square[1], board, channel] = 1.0
    tap = torch.arange(1, 10, dtype=torch.float32).reshape(3, 3, 1, 1)
    cc = torch.arange(cin, dtype=torch.float32).reshape(1, 1, cin, 1)
    oo = torch.arange(cout, dtype=torch.float32).reshape(1, 1, 1, cout)
    w = tap + 16.0 * ((cc + oo) % 3) + 64.0 * (oo % 2)
    return x.to(torch.bfloat16), w.to(torch.bfloat16)


def one_hot_expected(square: tuple[int, int], w: torch.Tensor, n: int, board: int,
                     channel: int) -> torch.Tensor:
    """What one_hot_inputs' conv must give, written out tap by tap."""
    out = torch.zeros(9, 9, n, w.shape[3])
    for di in range(3):
        for dj in range(3):
            i, j = square[0] - di + 1, square[1] - dj + 1
            if 0 <= i < 9 and 0 <= j < 9:
                out[i, j, board] = w[di, dj, channel].float()
    return out


def check(device, c: int = C) -> dict[int, float]:
    """Each boards-per-CTA kernel against the plain version at B=8 (and at
    B=7, a partial last CTA): max |got - ref| / max |ref| < 0.02, the TPU
    script's bound, and within rtol = atol = 0.05; and on the one-hot boards,
    equal to the taps laid out by hand. Raises on a disagreement; returns
    the relative errors at B=8."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(9, 9, CHECK_B, c, generator=g).to(torch.bfloat16).to(device)
    w = (torch.randn(3, 3, c, c, generator=g) * 0.05).to(torch.bfloat16).to(device)
    errs = {}
    for bpc in BOARDS_PER_CTA:
        for xb in (x, x[:, :, :7].contiguous()):
            err = compare_conv(bpc, conv3x3_bpc(xb, w, boards_per_cta=bpc),
                               conv3x3_hwbc_reference(xb, w))
            errs.setdefault(bpc, err)
        for name, square in ONE_HOT_SQUARES.items():
            xh, wh = one_hot_inputs(square, cin=c, cout=c)
            got = conv3x3_bpc(xh.to(device), wh.to(device), boards_per_cta=bpc).float().cpu()
            if not torch.equal(got, one_hot_expected(square, wh, 5, 2, c - 1)):
                raise AssertionError(f"conv3x3_bpc({bpc}) lays the taps of a one-hot board at "
                                     f"the {name} wrongly")
    return errs


def compare_conv(bpc: int, got: torch.Tensor, ref: torch.Tensor) -> float:
    """The bound for conv3x3_bpc: max |got - ref| / max |ref| < 0.02 and
    rtol = atol = 0.05. Raises outside it; returns the relative error."""
    got, ref = got.float(), ref.float()
    err = float((got - ref).abs().max() / ref.abs().max())
    if err >= 0.02 or not torch.allclose(got, ref, rtol=0.05, atol=0.05):
        raise AssertionError(f"conv3x3_bpc({bpc}) B={got.shape[2]} disagrees with the plain "
                             f"version: rel err {err:.5f}")
    return err


def cudnn_x(x: torch.Tensor) -> torch.Tensor:
    """(9, 9, B, C) -> F.conv2d's NCHW input in channels_last."""
    return x.permute(2, 3, 0, 1).contiguous(memory_format=torch.channels_last)


def cudnn_w(w: torch.Tensor) -> torch.Tensor:
    """HWIO -> F.conv2d's OIHW weight in channels_last."""
    return w.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)


def tile_sweep(device, bs: tuple[int, ...] = SWEEP_BS, c: int = C) -> dict:
    """ms of one conv (c -> c) at each B: through every tile of the wgmma
    kernel, one CTA per tile and persistent, each checked against the plain
    version first; through the mma.sync kernel; through cuDNN. Keys: (b,
    boards, cout_tile, persistent), (b, "mma_sync"), (b, "cudnn"), (b,
    "route") for the tile conv_route picks."""
    g = torch.Generator().manual_seed(1)
    w = (torch.randn(3, 3, c, c, generator=g) * 0.02).to(torch.bfloat16).to(device)
    res = {}
    for b in bs:
        x = torch.randn(9, 9, b, c, generator=g).to(torch.bfloat16).to(device)
        ref = conv3x3_hwbc_reference(x, w)
        for boards, cout_tile in WGMMA_TILES:
            for persistent in (False, True):
                route = ConvRoute("wgmma", boards, cout_tile, persistent)
                compare_conv(boards, ops._conv_wgmma(x, w, route), ref)
                res[(b, boards, cout_tile, persistent)] = graph_ms(
                    lambda: ops._conv_wgmma(x, w, route))
        res[(b, "mma_sync")] = graph_ms(lambda: ops._conv_mma_sync(x, w, 1))
        x_cl, w_cl = cudnn_x(x), cudnn_w(w)
        res[(b, "cudnn")] = graph_ms(lambda: F.conv2d(x_cl, w_cl, padding=1))
        res[(b, "route")] = conv_route(b, c, c)
        del x, ref, x_cl
    return res


def measure(device, b: int = B, c: int = C, blocks: int = BLOCKS, iters: int = 3) -> dict:
    """ms per chain of `blocks` convs (x <- conv(x, w) * 0.5) at (b, c) for
    each boards-per-CTA (int keys), through conv3x3_hwbc ("hwbc") and
    through cuDNN ("cudnn"), and the chain's conv FLOP ("flop")."""
    g = torch.Generator().manual_seed(0)
    ws = [(torch.randn(3, 3, c, c, generator=g) * 0.02).to(torch.bfloat16).to(device)
          for _ in range(blocks)]
    x0 = torch.full((9, 9, b, c), 0.01, dtype=torch.bfloat16, device=device)
    res = {"flop": 2.0 * 9 * 81 * b * c * c * blocks}
    for bpc in BOARDS_PER_CTA:
        res[bpc] = chain_ms(lambda x, w, bpc=bpc: conv3x3_bpc(x, w, boards_per_cta=bpc), ws, x0,
                            iters)
    res["hwbc"] = chain_ms(conv3x3_hwbc, ws, x0, iters)
    w_cl = [cudnn_w(w) for w in ws]
    del ws
    x0 = cudnn_x(x0)
    res["cudnn"] = chain_ms(lambda x, w: F.conv2d(x, w, padding=1), w_cl, x0, iters)
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_direct_conv: no CUDA device", file=sys.stderr)
        return 2
    print(card())
    dev = torch.device("cuda")
    torch.backends.cudnn.allow_tf32 = False
    for bpc, err in check(dev).items():
        print(f"conv3x3_bpc({bpc})-vs-plain conv rel err: {err:.5f}; one-hot boards equal")
    sweep = tile_sweep(dev)
    for b in SWEEP_BS:
        flop = 2.0 * 9 * 81 * b * C * C
        print(f"one conv B={b} C={C}: cuDNN {sweep[(b, 'cudnn')]:.4f} ms, mma.sync 1 board/CTA "
              f"{sweep[(b, 'mma_sync')]:.4f} ms; conv3x3_hwbc takes {sweep[(b, 'route')]}")
        for boards, cout_tile in WGMMA_TILES:
            one, pers = (sweep[(b, boards, cout_tile, p)] for p in (False, True))
            print(f"  wgmma tile {boards} x {cout_tile}: {one:.4f} ms "
                  f"({flop / one / 1e9:.1f} TFLOP/s), persistent {pers:.4f} ms")
    for b in CHAIN_BS:
        r = measure(dev, b)
        print(f"cuDNN conv x{BLOCKS} B={b}: {r['cudnn']:.2f} ms "
              f"({r['flop'] / r['cudnn'] / 1e9:.1f} TFLOP/s)")
        for key in (*BOARDS_PER_CTA, "hwbc"):
            name = f"conv3x3_bpc boards_per_cta={key}" if key != "hwbc" else "conv3x3_hwbc"
            print(f"{name} x{BLOCKS} B={b}: {r[key]:.2f} ms "
                  f"({r['flop'] / r[key] / 1e9:.1f} TFLOP/s; vs cuDNN {r['cudnn'] / r[key]:.2f}x)")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Operations, bytes and bounds of the SE-ResNet, computed from a
configuration's widths, and the card's published peaks.

Peaks: one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the 700 W power
limit): 989 TFLOP/s bf16, 3.35 TB/s HBM3. `bound` is chip_smoke.py's: the
least time the card could take, the larger of the operations over the peak
and the bytes (inputs read once, outputs written once) over the memory rate.
"""

from __future__ import annotations

from .reference import SPATIAL_MOVE_TYPES, Widths

PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12
SQUARES = 81


def bound_s(ops: float, nbytes: float) -> float:
    return max(ops / PEAK_BF16, nbytes / PEAK_BYTES)


def block_fc_macs(w: Widths) -> int:
    """Multiply-adds of a block's four in-block Dense layers, one board."""
    c, gpc, sec = w.channels, w.global_pool_channels, w.channels // w.se_reduction
    return 3 * c * gpc + gpc * c + c * sec + sec * 2 * c


def trunk_conv_flops(w: Widths) -> float:
    """The trunk's 3x3 convolutions in the blocks, one board: 2 x 81 x C*C*9
    multiply-adds each, two a block."""
    return w.num_blocks * 2 * 2.0 * SQUARES * w.channels * w.channels * 9


def forward_flops(w: Widths) -> float:
    """Every convolution and Dense layer of one board's forward (2 operations
    a multiply-add); the elementwise work is left out."""
    c = w.channels
    stem = 2.0 * SQUARES * w.obs_channels * c * 9
    fcs = w.num_blocks * 2.0 * block_fc_macs(w)
    policy = 2.0 * SQUARES * (c * w.policy_channels + w.policy_channels * SPATIAL_MOVE_TYPES)
    heads = 2.0 * (3 * c * w.value_fc_size + w.value_fc_size * 3
                   + 3 * c * w.score_fc_size + w.score_fc_size)
    return stem + trunk_conv_flops(w) + fcs + policy + heads


def training_flops(w: Widths, forwards: int, trained_rows: int) -> float:
    """Model FLOPs a training epoch needs: its rollout's board forwards, and
    a forward and a backward (3x a forward) for every row of every PPO
    epoch; nothing recomputed is counted."""
    f = forward_flops(w)
    return f * forwards + 3.0 * f * trained_rows


def trunk_bound_s(w: Widths, b: int) -> float:
    """The fused trunk's bound at B boards: the stem conv (its 50 planes)
    and one fused block per block, each bounded on its own, as chip_smoke.py
    bounds them."""
    c = w.channels
    stem = bound_s(2.0 * SQUARES * b * 9 * w.obs_channels * c,
                   2.0 * (SQUARES * b * w.obs_channels + 9 * w.obs_channels * c
                          + SQUARES * b * c))
    gpc, sec = w.global_pool_channels, c // w.se_reduction
    fc_bytes = 2.0 * block_fc_macs(w) + 4.0 * (gpc + c + sec + 2 * c + 4 * c)
    block = bound_s(2 * 2.0 * SQUARES * b * 9 * c * c + 2.0 * b * block_fc_macs(w),
                    2 * 2.0 * SQUARES * b * c + 2 * 2.0 * 9 * c * c + fc_bytes)
    return stem + w.num_blocks * block

"""The card's published peaks, the bound of a piece of work on it, and a
training epoch's model FLOPs from an architecture's per-board count. Each
architecture's own operations and bytes live in arch/<architecture>.py.

Peaks: one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the 700 W power
limit): 989 TFLOP/s bf16, 3.35 TB/s HBM3. `bound` is chip_smoke.py's: the
least time the card could take, the larger of the operations over the peak
and the bytes (inputs read once, outputs written once) over the memory rate.
"""

from __future__ import annotations

PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12
SQUARES = 81


def bound_s(ops: float, nbytes: float) -> float:
    return max(ops / PEAK_BF16, nbytes / PEAK_BYTES)


def training_flops(w, forwards: int, trained_rows: int, forward_flops=None) -> float:
    """Model FLOPs a training epoch needs: its rollout's board forwards, and
    a forward and a backward (3x a forward) for every row of every PPO
    epoch; nothing recomputed is counted. `forward_flops(w)` is the
    architecture's per-board count (arch/<architecture>.py), the SE-ResNet's
    where none is given."""
    if forward_flops is None:
        from bench_torch.reference import se_resnet
        forward_flops = se_resnet().forward_flops
    f = forward_flops(w)
    return f * forwards + 3.0 * f * trained_rows


# the SE-ResNet's names, under the names they had here before they moved to
# arch/se_resnet.py; looked up on first use, since that module imports this one
_MOVED = {"SPATIAL_MOVE_TYPES", "Widths", "block_fc_macs", "trunk_conv_flops",
          "forward_flops", "trunk_bound_s"}


def __getattr__(name: str):
    if name in _MOVED:
        from bench_torch.reference import se_resnet
        return getattr(se_resnet(), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

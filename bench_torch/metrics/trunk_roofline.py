"""The fused trunk's share of its roofline: the bound of the stem conv and
the blocks at B = N boards (bench_torch/flops.py) times the traced
forwards, over the device time of the trunk's kernels in the trace (the
wgmma conv kernels, the blocks' pool and SE kernels), in %."""

import re

from bench_torch.flops import trunk_bound_s
from bench_torch.reference import Widths

TRUNK = re.compile(r"conv3x3_wgmma_kernel|gp_pool_kernel|se_residual_kernel")


def read(record: dict):
    tr = record.get("traced")
    if not tr or not tr.get("forwards"):
        return None
    kernel_s = sum(s for name, s in tr["ops_s"].items() if TRUNK.search(name))
    if kernel_s <= 0:
        return None
    bound = trunk_bound_s(Widths(**record["widths"]), tr["boards_per_forward"])
    return 100.0 * bound * tr["forwards"] / kernel_s

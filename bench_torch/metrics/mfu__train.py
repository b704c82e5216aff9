"""The window's model FLOPs in its training epochs (the rollout's board
forwards the algorithm needs, N x (T+1) an epoch and one per env cut at
max_ply, and 3x a forward for every trained row; nothing recomputed) over
the window's wall time and the bf16 dense peak, in %."""

from bench_torch.flops import PEAK_BF16


def read(record: dict):
    if not record.get("on_card") or not record.get("window_flops"):
        return None  # a rate against the card's peak comes from the card alone
    return 100.0 * record["window_flops"] / record["window_s"] / PEAK_BF16

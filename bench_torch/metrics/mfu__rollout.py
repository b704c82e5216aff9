"""The window's model FLOPs in its rollout calls (the board forwards the
algorithm needs: N x (T+1) a call and one per env cut at max_ply; not the
padding of the full-batch truncation forward) over the window's wall time
and the bf16 dense peak, in %."""

from bench_torch.flops import PEAK_BF16


def read(record: dict):
    if not record.get("on_card") or not record.get("window_flops"):
        return None  # a rate against the card's peak comes from the card alone
    return 100.0 * record["window_flops"] / record["window_s"] / PEAK_BF16

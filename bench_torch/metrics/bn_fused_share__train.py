"""Share of the traced training epoch's train-mode BatchNorm calls that ran
on the program's kernels: 100 x the program's `bn.train.fused` counter over
its `bn.train` counter (PPO update: input_bn, policy_bn1 and each block's
bn1 and bn2, a minibatch's forward). A program that does not count them
gives nothing."""

from bench_torch.program_spans import stretch


def read(record: dict):
    got = stretch(record)
    if got is None or not got[1].get("bn.train"):
        return None
    return 100.0 * got[1].get("bn.train.fused", 0) / got[1]["bn.train"]

"""Mean host ms of a PPO minibatch in the traced training epoch (the
program's `minibatch` span: forward, backward, clip and Adam issued,
including any block on a full launch queue)."""

from bench_torch.program_spans import mean_host_ms


def read(record: dict):
    return mean_host_ms(record, "minibatch")

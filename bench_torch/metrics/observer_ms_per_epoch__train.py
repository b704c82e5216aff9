"""Host ms of the traced training epoch's observer work after its upkeep
(the program's `phase.observe` span: the metrics sink, the observer's
writes and the board snapshot)."""

from bench_torch.program_spans import mean_host_ms


def read(record: dict):
    return mean_host_ms(record, "phase.observe")

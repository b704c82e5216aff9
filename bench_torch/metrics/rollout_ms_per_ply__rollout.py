"""Host ms of the traced rollout calls per ply: the program's `rollout`
spans over their `ply` spans, so a ply's launches and every wait of the
call (its truncation checks, the read of its counts), wherever the wait
lands."""

from bench_torch.program_spans import rollout_ms_per_ply


def read(record: dict):
    return rollout_ms_per_ply(record)

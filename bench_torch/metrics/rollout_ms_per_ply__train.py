"""Host ms of the traced training epoch's rollout per ply: the program's
`rollout` span over its `ply` spans, so a ply's launches and every wait of
the rollout (its truncation checks, the read of its counts), wherever the
wait lands."""

from bench_torch.program_spans import rollout_ms_per_ply


def read(record: dict):
    return rollout_ms_per_ply(record)

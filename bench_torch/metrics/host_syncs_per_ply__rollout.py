"""Host syncs a ply in the traced rollout calls: the program's
`host_syncs` counter over its `plies` counter (a truncation check each ply
and one read of the call's counts: (16 + 1) / 16 at T = 16)."""

from bench_torch.program_spans import per_ply


def read(record: dict):
    return per_ply(record, "host_syncs")

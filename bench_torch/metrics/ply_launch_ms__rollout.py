"""Mean host ms of a ply of the traced rollout calls outside its host-sync
spans: the time the host spends issuing the ply (the program's `ply` span
less its `truncation.check`)."""

from bench_torch.program_spans import ply_launch_ms


def read(record: dict):
    return ply_launch_ms(record)

"""Mean ms of an engine step (EnvCore.step) over the traced training
epoch's plies, by the CUDA events of the program's `engine.step` span: its
device time, or its enqueue time where the host launches slower than the
card runs (engine_ms_per_ply.rollout's definition, from inside the
program)."""

from bench_torch.program_spans import mean_device_ms


def read(record: dict):
    return mean_device_ms(record, "engine.step")

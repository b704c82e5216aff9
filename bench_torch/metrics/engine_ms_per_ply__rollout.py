"""Mean ms of an engine step (EnvCore.step) over the window's plies, by
CUDA events before and after each step: its device time, or its enqueue
time where the host launches slower than the card runs."""


def read(record: dict):
    ms = record.get("engine_ms")
    if not ms:
        return None
    return sum(ms) / len(ms)

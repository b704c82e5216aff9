"""The share of the traced training epoch in which no kernel, copy or
memset ran on the card, in %."""


def read(record: dict):
    tr = record.get("traced")
    if not tr or not tr["busy_s"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])

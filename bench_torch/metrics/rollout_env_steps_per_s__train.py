"""Self-play env-steps a second of the rollout alone in the window's
training epochs: N x T x epochs over the sum of EpochMetrics.rollout_time."""


def read(record: dict):
    epochs = record.get("epochs")
    if not epochs:
        return None
    return record["N"] * record["T"] * len(epochs) / sum(e["rollout_time"] for e in epochs)

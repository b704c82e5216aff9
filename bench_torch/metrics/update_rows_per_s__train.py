"""Rows a second through the PPO update in the window's training epochs:
the rows of every full minibatch of every PPO epoch over the sum of
EpochMetrics.update_time."""


def read(record: dict):
    epochs = record.get("epochs")
    if not epochs:
        return None
    hp = record["hp"]
    rows = hp["epochs_per_batch"] * (record["N"] * record["T"] // hp["batch_size"]) \
        * hp["batch_size"]
    return rows * len(epochs) / sum(e["update_time"] for e in epochs)

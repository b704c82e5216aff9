"""Data parallelism: one process (rank) per card (counterpart of keisei_tpu/parallel/).

distributed: the launch environment (KEISEI_*), the process group, seeds,
the broadcast from rank 0. mesh: the rank layout, the env shard of a rank,
replication from rank 0 and the collectives the trainer counts.
placement: per-role device specs.
"""

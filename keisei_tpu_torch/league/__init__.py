"""Opponent league (counterpart of keisei_tpu/league/): the snapshot store,
the tiers, the scheduler, the historical library and gauntlet, frozen
matches and the cohort glue, the tournament (in-process rounds on the
concurrent match pool, the sidecar dispatcher and worker), the
Dynamic-entry online trainer, behavioral features and style profiles, and
head-to-head evaluation.
"""

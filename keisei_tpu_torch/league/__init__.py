"""Opponent league (counterpart of keisei_tpu/league/): the snapshot store,
the tiers, the scheduler, the historical library and gauntlet, frozen
matches and the cohort glue. The in-process tournament, the sidecar
workers, evaluation and the Dynamic-entry update path are not ported yet.
"""

"""keisei_tpu_torch: the PyTorch + CUDA port of keisei_tpu for NVIDIA Hopper.

Same module names as the JAX package, so each part has an obvious
counterpart there. The framework-free modules of `keisei_tpu` (engine
tables, types, Zobrist keys, SFEN, the oracle, `db/`, the training
observer) are imported, not copied. This package never imports JAX.

Subpackages: engine (batched rules core), env (EnvCore), models (SE-ResNet,
fused eval forward, flax weight converter), ops (hand-written CUDA kernels
with their plain PyTorch versions), training (GAE, PPO, rollout, loop),
utils (device resolution).
"""

__version__ = "0.1.0"

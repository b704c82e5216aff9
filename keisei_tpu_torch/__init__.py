"""keisei_tpu_torch: the PyTorch + CUDA port of keisei_tpu for NVIDIA Hopper.

Same module names as the JAX package, so each part has an obvious
counterpart there. The framework-free modules it needs from `keisei_tpu`
(engine tables, types, Zobrist keys, SFEN, the spectator data, the
training observer and its part of `db/`) are copies of their own, held
equal to the originals by tests/test_torch_copies.py. This package never
imports JAX or `keisei_tpu`.

Subpackages: db (the trainer's SQLite writes), engine (batched rules core),
env (EnvCore, spectator data), models (SE-ResNet,
fused eval forward, flax weight converter), ops (hand-written CUDA kernels
with their plain PyTorch versions), training (GAE, PPO, rollout, loop),
utils (device resolution).
"""

__version__ = "0.1.0"

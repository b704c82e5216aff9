"""One plain reference module per model architecture, found by name.

A configuration's `model.architecture` names `arch/<architecture>.py` under
the benchmark's root; the cells take from it everything that depends on
the architecture, so that a configuration of another architecture comes in
as new files. A module keeps this contract:

- `Widths`: a dataclass of the sizes the reference needs, with
  `Widths.from_params(params)` reading them from the configuration's
  `model.params`, and an `obs_channels` field (the observation's planes).
- `init_state(w, seed, device)`: the program's whole state dict (its names,
  its shapes, buffers too), drawn from `seed` on `device`. The benchmark
  loads it into the program, and the reference draws it again.
- `parameter_names(w)`: the trainable tensors of that state, in the order
  in which the reference's optimizer holds them.
- `Net(w, quant=None)`: `forward(P, obs, train)` over a state dict `P` and
  (B, obs_channels * 81) observations, returning (policy logits
  (B, 9, 9, 139), W/D/L logits (B, 3), score (B, 1)) in float32, and
  `eval_rows(P, obs)`, the eval forward in blocks of rows without
  gradients. `quant`, a function of a tensor, is applied to what the
  configuration runs in bf16 (the control's lower precision).
- `forward_flops(w)`: the model FLOPs of one board's forward (2 a
  multiply-add), as the program's kernels need them.
- `TRAIN_ROWS_PER_BLOCK`: None where the train-mode forward mixes rows (as
  BatchNorm's batch statistics do), so the reference's step takes a whole
  minibatch at once; otherwise the rows of one block of that step
  (`reference.follow_steps`), which bounds the reference's memory.
- `ROLLOUT_CONTROL`: the rollout cell's control. The name of the program's
  own lower-precision rollout forward (a kind `rollout_cell.make_forward`
  builds, such as "int8"), which then takes the program's place; or None,
  and the reference with `quant=reference.fp8_e4m3` takes it.

The module imports nothing of the program; it may import `bench_torch`'s
generic parts (`reference`, `flops`).
"""

from __future__ import annotations

import hashlib
import importlib.util
import sys
from pathlib import Path
from types import ModuleType


def load(root: Path, architecture: str) -> ModuleType:
    """`root`/arch/<architecture>.py, executed once per file."""
    path = (Path(root) / "arch" / f"{architecture}.py").resolve()
    if not path.is_file():
        raise ModuleNotFoundError(
            f"no reference for architecture {architecture!r}: {path} does not exist")
    name = f"bench_arch_{architecture}_{hashlib.sha1(str(path).encode()).hexdigest()[:12]}"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod  # before it runs: dataclasses look their module up
        try:
            spec.loader.exec_module(mod)
        except BaseException:
            del sys.modules[name]
            raise
    return sys.modules[name]

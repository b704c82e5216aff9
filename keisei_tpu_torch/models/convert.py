"""flax SE-ResNet variables -> a state_dict of the port's SEResNetModel.

Takes plain numpy trees (`jax.device_get(variables)` or an unpacked
checkpoint), so this module needs no JAX:
- conv kernels HWIO (kh, kw, in, out) -> OIHW;
- Dense kernels (in, out) -> Linear weight (out, in);
- BatchNorm scale/bias -> weight/bias, batch_stats mean/var ->
  running_mean/running_var;
- every bias (incl. policy_conv2's) as is.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch


def _walk(tree: Mapping[str, Any], prefix: str = ""):
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, Mapping):
            yield from _walk(v, name + ".")
        else:
            yield name, np.asarray(v, dtype=np.float32)


def flax_to_torch(params: Mapping[str, Any],
                  batch_stats: Mapping[str, Any] | None = None) -> dict[str, torch.Tensor]:
    """state_dict for SEResNetModel from flax `params` and `batch_stats`."""
    sd: dict[str, torch.Tensor] = {}
    for name, a in _walk(params):
        mod, leaf = name.rsplit(".", 1)
        if leaf == "kernel":
            if a.ndim == 4:
                a = a.transpose(3, 2, 0, 1)
            elif a.ndim == 2:
                a = a.T
            else:
                raise ValueError(f"unexpected kernel rank {a.ndim} at {name}")
            sd[f"{mod}.weight"] = torch.from_numpy(np.array(a, copy=True))
        elif leaf == "scale":
            sd[f"{mod}.weight"] = torch.from_numpy(a.copy())
        elif leaf == "bias":
            sd[f"{mod}.bias"] = torch.from_numpy(a.copy())
        else:
            raise ValueError(f"unexpected parameter {name}")
    for name, a in _walk(batch_stats or {}):
        mod, leaf = name.rsplit(".", 1)
        if leaf not in ("mean", "var"):
            raise ValueError(f"unexpected batch stat {name}")
        sd[f"{mod}.running_{leaf}"] = torch.from_numpy(a.copy())
    return sd

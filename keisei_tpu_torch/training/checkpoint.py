"""Checkpoints with torch.save (counterpart of keisei_tpu/training/checkpoint.py).

One file per checkpoint directory, `state.pt`: model parameters and
BatchNorm buffers, Adam state (learning rate included), the training
generator's state, plus a JSON sidecar `keisei_meta.json` (epoch,
architecture, plateau-scheduler state; phase="sl" for the SL trainer's)
as in the JAX package. Writes go to a temporary name and are renamed into
place. `checkpoint_payload(copy=True)` + `write_checkpoint` split a save
into a device copy and a write that may run on another thread. Orbax
checkpoints of the JAX package are not read; models/convert.py carries
their weights over.

Data parallelism: rank 0 writes, asynchronous saves included, and every
rank loads. A checkpoint restores exactly at any number of ranks W:
parameters, BatchNorm statistics and Adam state are the same on every
rank. The generator it holds is the trainer's, which draws the update's
permutations in the same state on every rank (and, on one rank, the
rollout's noise too); every rank restores it. The ranks' own rollout
generators at W > 1 are not stored: on resume, rank r's is seeded with
process_seed(seed + epoch * W, r) (training/loop.py:_rank_generator).
"""

from __future__ import annotations

import json
import os
import shutil

import torch

META_NAME = "keisei_meta.json"
STATE_NAME = "state.pt"


class CheckpointError(RuntimeError):
    pass


def checkpoint_payload(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                       generator: torch.Generator, *, copy: bool = False) -> dict:
    """What `state.pt` holds. copy=True clones every tensor where it lies
    (on the card: a device-to-device copy), so that a writer on another
    thread reads the state as it was, while the next update changes the
    live parameters and the optimizer state in place."""
    payload = {
        "model": model.state_dict(),
        "optimizer": optimizer.state_dict(),
        "generator": generator.get_state(),
    }
    if not copy:
        return payload

    def clone(x):
        if isinstance(x, torch.Tensor):
            return x.detach().clone()
        if isinstance(x, dict):
            out = type(x)((k, clone(v)) for k, v in x.items())
            if hasattr(x, "_metadata"):  # a module state dict's versions
                out._metadata = x._metadata
            return out
        if isinstance(x, (list, tuple)):
            return type(x)(clone(v) for v in x)
        return x

    return clone(payload)


def save_checkpoint(path: str, model: torch.nn.Module, optimizer: torch.optim.Optimizer, *,
                    epoch: int, architecture: str, generator: torch.Generator,
                    extra_meta: dict | None = None) -> None:
    write_checkpoint(path, checkpoint_payload(model, optimizer, generator), epoch=epoch,
                     architecture=architecture, extra_meta=extra_meta)


def write_checkpoint(path: str, payload: dict, *, epoch: int, architecture: str,
                     extra_meta: dict | None = None) -> None:
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, STATE_NAME + ".tmp")
    torch.save(payload, tmp)
    os.replace(tmp, os.path.join(path, STATE_NAME))
    meta = {"epoch": int(epoch), "architecture": architecture, "format_version": 1,
            "framework": "torch", **(extra_meta or {})}
    tmp = os.path.join(path, META_NAME + ".tmp")
    with open(tmp, "w") as f:
        json.dump(meta, f)
    os.replace(tmp, os.path.join(path, META_NAME))


def load_meta(path: str) -> dict:
    with open(os.path.join(path, META_NAME)) as f:
        return json.load(f)


def load_checkpoint(path: str, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
                    generator: torch.Generator, *, architecture: str,
                    skip_optimizer: bool = False) -> dict:
    """Restore model, optimizer and generator in place; returns the meta.

    skip_optimizer=True (the SL -> RL warm start) restores the model's
    state dict only (parameters and BatchNorm statistics) and leaves the
    optimizer and the generator as they are: the saved optimizer may have
    another structure (the SL trainer's), and it is never materialized
    (the file is memory-mapped and only the model's tensors are read)."""
    meta = load_meta(path)
    if meta["architecture"] != architecture:
        raise CheckpointError(f"checkpoint architecture {meta['architecture']!r} does not "
                              f"match configured architecture {architecture!r}")
    state_file = os.path.join(path, STATE_NAME)
    if not os.path.isfile(state_file):
        raise CheckpointError(f"{path} has no {STATE_NAME} (not a keisei_tpu_torch checkpoint)")
    dev = next(model.parameters()).device
    if skip_optimizer:
        payload = torch.load(state_file, map_location="cpu", weights_only=True, mmap=True)
    else:
        payload = torch.load(state_file, map_location=dev, weights_only=True)
    try:
        model.load_state_dict(payload["model"])
    except RuntimeError as e:
        raise CheckpointError(f"checkpoint restore failed: {e}") from e
    if skip_optimizer:
        return meta
    optimizer.load_state_dict(payload["optimizer"])
    generator.set_state(payload["generator"].cpu())
    return meta


def prune_checkpoints(directory: str, keep: int) -> None:
    """Keep the newest `keep` epoch checkpoints (0 = all); SL ones stay."""
    if keep <= 0:
        return
    entries = []
    for name in os.listdir(directory):
        p = os.path.join(directory, name)
        if os.path.isfile(os.path.join(p, META_NAME)):
            meta = load_meta(p)
            if meta.get("phase") != "sl":
                entries.append((meta.get("epoch", -1), p))
    entries.sort(reverse=True)
    for _, p in entries[keep:]:
        shutil.rmtree(p, ignore_errors=True)

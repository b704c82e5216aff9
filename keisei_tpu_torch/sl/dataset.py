"""Binary shard format + memory-mapped dataset for SL positions.

Shard layout is byte-identical to the reference (keisei/sl/dataset.py:16-43)
so shards interoperate: per record float32[50*81] obs + int64 policy +
int64 value + float32 score = 16,220 bytes. `shard_meta.json` carries
counts and the placeholder flag (ours is always false — the encoder is
real). Reads are zero-copy numpy memmaps with an LRU of open maps; target
domains are validated on read (policy in [0, 11259), value in {0,1,2}).
"""

from __future__ import annotations

import json
import logging
from collections import OrderedDict
from pathlib import Path

import numpy as np

logger = logging.getLogger(__name__)

OBS_SIZE = 50 * 81
RECORD_SIZE = OBS_SIZE * 4 + 8 + 8 + 4  # 16,220 bytes

SCORE_NORMALIZATION = 76.0  # shared with RL (training/ppo.py)

SHARD_DTYPE = np.dtype([
    ("obs", np.float32, (OBS_SIZE,)),
    ("policy", np.int64),
    ("value", np.int64),
    ("score", np.float32),
])
assert SHARD_DTYPE.itemsize == RECORD_SIZE


def write_shard(path: Path, observations, policy_targets, value_targets,
                score_targets) -> None:
    n = observations.shape[0]
    assert observations.shape == (n, OBS_SIZE)
    buf = np.empty(n, dtype=SHARD_DTYPE)
    buf["obs"] = observations.astype(np.float32)
    buf["policy"] = np.asarray(policy_targets, np.int64)
    buf["value"] = np.asarray(value_targets, np.int64)
    buf["score"] = np.asarray(score_targets, np.float32)
    tmp = Path(str(path) + ".tmp")
    buf.tofile(tmp)
    tmp.replace(path)


def write_meta(output_dir: Path, shard_counts: list[int],
               placeholder: bool = False, extra: dict | None = None) -> None:
    meta = {
        "num_shards": len(shard_counts),
        "shard_counts": shard_counts,
        "total_positions": int(sum(shard_counts)),
        "record_size": RECORD_SIZE,
        "placeholder": placeholder,
        **(extra or {}),
    }
    tmp = output_dir / "shard_meta.json.tmp"
    tmp.write_text(json.dumps(meta, indent=1))
    tmp.replace(output_dir / "shard_meta.json")


class SLDataset:
    """Memory-mapped random-access dataset over shard_*.bin files."""

    def __init__(self, data_dir: str, mmap_cache_size: int = 8,
                 allow_placeholder: bool = False):
        self.data_dir = Path(data_dir)
        self._cache: OrderedDict[int, np.memmap] = OrderedDict()
        self._cache_size = mmap_cache_size

        meta_path = self.data_dir / "shard_meta.json"
        self.meta = json.loads(meta_path.read_text()) if meta_path.exists() else {}
        if self.meta.get("placeholder") and not allow_placeholder:
            raise ValueError(
                "shards were written in placeholder mode (all-zero "
                "observations) — refusing to train on them"
            )

        self.shards = sorted(self.data_dir.glob("shard_*.bin"))
        self.counts = []
        for p in self.shards:
            size = p.stat().st_size
            if size % RECORD_SIZE != 0:
                logger.warning("shard %s size %d not a multiple of record "
                               "size — truncating trailing bytes", p, size)
            self.counts.append(size // RECORD_SIZE)
        self.offsets = np.cumsum([0] + self.counts)

    def __len__(self) -> int:
        return int(self.offsets[-1])

    def _mmap(self, shard_idx: int) -> np.memmap:
        if shard_idx in self._cache:
            self._cache.move_to_end(shard_idx)
            return self._cache[shard_idx]
        m = np.memmap(self.shards[shard_idx], dtype=SHARD_DTYPE, mode="r",
                      shape=(self.counts[shard_idx],))
        self._cache[shard_idx] = m
        while len(self._cache) > self._cache_size:
            self._cache.popitem(last=False)
        return m

    def __getitem__(self, idx: int) -> dict:
        if not 0 <= idx < len(self):
            raise IndexError(idx)
        shard = int(np.searchsorted(self.offsets, idx, side="right")) - 1
        rec = self._mmap(shard)[idx - self.offsets[shard]]
        policy, value = int(rec["policy"]), int(rec["value"])
        if not 0 <= policy < 11259:
            raise ValueError(f"invalid policy_target={policy} at index {idx}")
        if value not in (0, 1, 2):
            raise ValueError(f"invalid value_target={value} at index {idx}")
        return {
            "observation": np.array(rec["obs"], np.float32),
            "policy_target": policy,
            "value_target": value,
            "score_target": float(rec["score"]),
        }

    def batches(self, batch_size: int, rng: np.random.Generator | None = None,
                drop_last: bool = True, order: np.ndarray | None = None):
        """Minibatches as stacked numpy arrays (one epoch).

        With `order=None` the epoch is shuffled by `rng`; passing an explicit
        index array iterates exactly those positions in that order (used for
        held-out evaluation splits, where the subset must stay fixed and
        disjoint from the training ids)."""
        if order is None:
            if rng is None:
                raise ValueError("batches() needs rng when order is None")
            order = rng.permutation(len(self))
        else:
            order = np.asarray(order, dtype=np.int64)
        end = len(order) - (len(order) % batch_size) if drop_last else len(order)
        for start in range(0, end, batch_size):
            ids = order[start : start + batch_size]
            obs = np.empty((len(ids), OBS_SIZE), np.float32)
            pol = np.empty(len(ids), np.int64)
            val = np.empty(len(ids), np.int64)
            sc = np.empty(len(ids), np.float32)
            # group reads by shard (and in-shard order) for mmap locality;
            # writes land at each id's shuffled batch position
            shards = np.searchsorted(self.offsets, ids, side="right") - 1
            for shard in np.unique(shards):
                sel = np.nonzero(shards == shard)[0]
                sel = sel[np.argsort(ids[sel])]
                mm = self._mmap(int(shard))
                recs = mm[ids[sel] - self.offsets[shard]]
                obs[sel] = recs["obs"]
                pol[sel] = recs["policy"]
                val[sel] = recs["value"]
                sc[sel] = recs["score"]
            if not ((pol >= 0) & (pol < 11259)).all():
                raise ValueError("invalid policy target in batch")
            if not np.isin(val, (0, 1, 2)).all():
                raise ValueError("invalid value target in batch")
            yield {"observation": obs, "policy_target": pol,
                   "value_target": val, "score_target": sc}

"""Style profiling: percentile-ranked behavioral metrics -> style labels.

Reference semantics (keisei/training/style_profiler.py:64-114): aggregate
each entry's game_features into per-entry metrics, percentile-rank them
across the pool, fire rule-based labels with contradiction exclusions, and
write style_profiles rows with generated commentary.
"""

from __future__ import annotations

import datetime
import json
import logging
from collections import Counter

import numpy as np

from .. import db

logger = logging.getLogger(__name__)

MIN_GAMES_FOR_PROFILE = 8

# (label, {metric: (comparator, threshold_percentile)}) — reference
# style_profiler.py:64-105
STYLE_RULES: list[tuple[str, dict[str, tuple[str, float]]]] = [
    ("Sharp tactical opener", {"first_capture_ply_mean": ("<=", 30),
                               "avg_game_length": ("<=", 45)}),
    ("Patient attacker", {"avg_game_length": (">=", 65),
                          "num_captures_mean": (">=", 55)}),
    ("Drop-heavy scrapper", {"drops_per_game": (">=", 75),
                             "num_early_drops_mean": (">=", 60)}),
    ("Slow builder", {"avg_game_length": (">=", 70),
                      "first_capture_ply_mean": (">=", 60)}),
    ("Flexible opener", {"opening_diversity_index": (">=", 75)}),
    ("Aggressive promoter", {"promotions_per_game": (">=", 75),
                             "first_capture_ply_mean": ("<=", 40)}),
    ("Chaotic brawler", {"avg_game_length": ("<=", 35),
                         "num_captures_mean": (">=", 65),
                         "drops_per_game": (">=", 55)}),
    ("Long-game grinder", {"avg_game_length": (">=", 80),
                           "game_length_variance": ("<=", 40)}),
    ("Early rook swinger", {"rook_moved_early_rate": (">=", 70)}),
    ("Defensive builder", {"king_moves_early_rate": (">=", 65),
                           "first_capture_ply_mean": (">=", 55)}),
]

CONTRADICTIONS = [
    ("Sharp tactical opener", "Slow builder"),
    ("Sharp tactical opener", "Patient attacker"),
    ("Chaotic brawler", "Slow builder"),
    ("Chaotic brawler", "Long-game grinder"),
    ("Aggressive promoter", "Defensive builder"),
]


def aggregate_metrics(rows: list[dict]) -> dict[str, float] | None:
    """Per-entry raw metrics from its game_features rows."""
    if len(rows) < MIN_GAMES_FOR_PROFILE:
        return None
    lengths = np.array([r["total_plies"] for r in rows], float)
    caps = np.array([r["num_captures"] for r in rows], float)
    drops = np.array([r["num_drops"] for r in rows], float)
    early_drops = np.array([r["num_early_drops"] for r in rows], float)
    promos = np.array([r["num_promotions"] for r in rows], float)
    fc = np.array([r["first_capture_ply"] if r["first_capture_ply"] is not None
                   else r["total_plies"] for r in rows], float)
    rook_early = np.array([
        1.0 if (r["rook_moved_ply"] is not None and r["rook_moved_ply"] < 20)
        else 0.0 for r in rows
    ])
    king_early = np.array([
        1.0 if r["king_moves_in_30"] > 0 else 0.0 for r in rows
    ])
    openings = Counter(r["opening_seq_3"] for r in rows if r["opening_seq_3"])
    diversity = len(openings) / max(len(rows), 1)
    return {
        "avg_game_length": float(lengths.mean()),
        "game_length_variance": float(lengths.var()),
        "num_captures_mean": float(caps.mean()),
        "drops_per_game": float(drops.mean()),
        "num_early_drops_mean": float(early_drops.mean()),
        "promotions_per_game": float(promos.mean()),
        "first_capture_ply_mean": float(fc.mean()),
        "rook_moved_early_rate": float(rook_early.mean()),
        "king_moves_early_rate": float(king_early.mean()),
        "opening_diversity_index": float(diversity),
        "games": float(len(rows)),
    }


def percentile_rank(metrics_by_entry: dict[int, dict[str, float]]) -> dict[int, dict[str, float]]:
    """Each entry's percentile (0-100) per metric across the pool."""
    if not metrics_by_entry:
        return {}
    keys = next(iter(metrics_by_entry.values())).keys()
    out = {eid: {} for eid in metrics_by_entry}
    for k in keys:
        vals = np.array([m[k] for m in metrics_by_entry.values()])
        for eid in metrics_by_entry:
            v = metrics_by_entry[eid][k]
            out[eid][k] = float((vals <= v).mean() * 100.0)
    return out


def assign_labels(pct: dict[str, float]) -> list[str]:
    fired = []
    for label, rules in STYLE_RULES:
        ok = True
        for metric, (cmp_, thr) in rules.items():
            v = pct.get(metric)
            if v is None or (cmp_ == "<=" and v > thr) or (cmp_ == ">=" and v < thr):
                ok = False
                break
        if ok:
            fired.append(label)
    for a, b in CONTRADICTIONS:
        if a in fired and b in fired:
            # keep the earlier-ranked rule
            fired.remove(b if fired.index(a) < fired.index(b) else a)
    return fired


def commentary_for(labels: list[str], pct: dict[str, float]) -> list[str]:
    lines = []
    if labels:
        lines.append(f"Plays like a {labels[0].lower()}.")
    if pct.get("drops_per_game", 0) >= 75:
        lines.append("Rarely keeps a piece in hand for long.")
    if pct.get("avg_game_length", 0) >= 80:
        lines.append("Comfortable grinding long endgames.")
    if pct.get("first_capture_ply_mean", 100) <= 30:
        lines.append("Opens exchanges early and often.")
    return lines


class StyleProfiler:
    def __init__(self, db_path: str):
        self.db_path = db_path

    def recompute_all(self) -> int:
        """Aggregate features for every entry with data, rank, label, write.
        Returns profiles written (reference: every 5 tournament rounds)."""
        rows = db.read_all_game_features(self.db_path)
        by_entry: dict[int, list[dict]] = {}
        for r in rows:
            by_entry.setdefault(r["checkpoint_id"], []).append(r)
        metrics = {}
        for eid, feats in by_entry.items():
            m = aggregate_metrics(feats)
            if m is not None:
                metrics[eid] = m
        pcts = percentile_rank(metrics)
        now = datetime.datetime.now(datetime.UTC).strftime("%Y-%m-%dT%H:%M:%SZ")
        written = 0
        for eid, feats in by_entry.items():
            if eid in metrics:
                labels = assign_labels(pcts[eid])
                db.write_style_profile(self.db_path, {
                    "checkpoint_id": eid,
                    "recomputed_at": now,
                    "profile_status": "ok",
                    "games_sampled": len(feats),
                    "raw_metrics_json": json.dumps(metrics[eid]),
                    "percentile_json": json.dumps(pcts[eid]),
                    "primary_style": labels[0] if labels else None,
                    "secondary_traits": json.dumps(labels[1:]),
                    "commentary_json": json.dumps(
                        commentary_for(labels, pcts[eid])),
                })
            else:
                db.write_style_profile(self.db_path, {
                    "checkpoint_id": eid,
                    "recomputed_at": now,
                    "profile_status": "insufficient",
                    "games_sampled": len(feats),
                })
            written += 1
        return written

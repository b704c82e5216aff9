"""Head-to-head evaluation CLI: checkpoint A vs checkpoint B (counterpart of
keisei_tpu/league/evaluate.py), on the port's checkpoints
(training/checkpoint.py).

    python -m keisei_tpu_torch.league.evaluate --a <ckpt> --b <ckpt> \
        [--games N] [--device cuda]

plays batched games and reports win rate, Elo delta, and a Wilson 95%
confidence interval. Runs on the card unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import json
import logging
import math
import os
from dataclasses import asdict, dataclass

import torch

from ..models.registry import build_model
from ..training.checkpoint import STATE_NAME, load_meta
from ..utils.device import resolve_device
from .match import MatchResult, play_match

logger = logging.getLogger(__name__)


@dataclass
class EvalResult:
    games: int
    wins_a: int
    wins_b: int
    draws: int
    win_rate_a: float  # draws count 0.5
    elo_delta: float
    wilson_low: float
    wilson_high: float

    @classmethod
    def from_match(cls, m: MatchResult) -> EvalResult:
        return cls.from_counts(m.wins_a, m.wins_b, m.draws, m.games)

    @classmethod
    def from_counts(cls, wins_a: int, wins_b: int, draws: int,
                    games: int) -> EvalResult:
        """Aggregate W/L/D counts (e.g. summed over repeated matches) into
        a scored result; draws count 0.5."""
        wr = (wins_a + 0.5 * draws) / max(games, 1)
        return cls(
            games=games, wins_a=wins_a, wins_b=wins_b, draws=draws,
            win_rate_a=wr, elo_delta=elo_delta(wr),
            wilson_low=wilson_interval(wr, games)[0],
            wilson_high=wilson_interval(wr, games)[1],
        )


def elo_delta(win_rate: float) -> float:
    """-400 * log10(1/wr - 1), clamped away from 0/1."""
    wr = min(max(win_rate, 1e-3), 1 - 1e-3)
    return -400.0 * math.log10(1.0 / wr - 1.0)


def wilson_interval(p: float, n: int, z: float = 1.96) -> tuple[float, float]:
    """Wilson score interval for a binomial proportion."""
    if n == 0:
        return 0.0, 1.0
    denom = 1 + z * z / n
    center = (p + z * z / (2 * n)) / denom
    half = z * math.sqrt(p * (1 - p) / n + z * z / (4 * n * n)) / denom
    return max(0.0, center - half), min(1.0, center + half)


def _model_params(meta: dict) -> dict:
    """The checkpoint's model params; integers that an older trainer wrote
    as strings are read back as integers."""
    return {k: int(v) if isinstance(v, str) and v.isdigit() else v
            for k, v in meta.get("model_params", {}).items()}


def _load_model_and_vars(path: str, device: torch.device):
    """The model recorded in a checkpoint's metadata and its state dict
    (parameters + BatchNorm statistics) on `device`."""
    meta = load_meta(path)
    model, _ = build_model(meta["architecture"], _model_params(meta))
    payload = torch.load(os.path.join(path, STATE_NAME), map_location=device,
                         weights_only=True)
    return model.to(device).eval(), payload["model"], meta


def run_evaluation(
    ckpt_a: str,
    ckpt_b: str,
    *,
    games: int = 64,
    max_ply: int = 512,
    temperature: float = 1.0,
    seed: int = 0,
    device: str | torch.device = "cuda",
) -> EvalResult:
    device = resolve_device(device)
    model_a, vars_a, meta_a = _load_model_and_vars(ckpt_a, device)
    model_b, vars_b, meta_b = _load_model_and_vars(ckpt_b, device)
    logger.info(
        "evaluating %s (epoch %s) vs %s (epoch %s), %d games",
        ckpt_a, meta_a.get("epoch"), ckpt_b, meta_b.get("epoch"), games,
    )
    m = play_match(
        model_a, vars_a, model_b, vars_b,
        num_games=games, max_ply=max_ply, temperature=temperature, seed=seed,
    )
    return EvalResult.from_match(m)


def main(argv=None):
    p = argparse.ArgumentParser(description="keisei_tpu_torch head-to-head evaluation")
    p.add_argument("--a", required=True, help="checkpoint dir for player A")
    p.add_argument("--b", required=True, help="checkpoint dir for player B")
    p.add_argument("--games", type=int, default=64)
    p.add_argument("--max-ply", type=int, default=512)
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO, force=True)

    result = run_evaluation(
        args.a, args.b, games=args.games, max_ply=args.max_ply,
        temperature=args.temperature, seed=args.seed, device=args.device,
    )
    print(json.dumps(asdict(result), indent=1))


if __name__ == "__main__":
    main()

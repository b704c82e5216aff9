"""Game records -> encoded training shards (counterpart of
keisei_tpu/sl/prepare.py, the `keisei-tpu-prepare-sl` CLI).

Parse -> filter -> batched encode on the port's engine (encode.py, on
`device`) -> binary shards + shard_meta.json, byte-identical to what the
JAX package writes from the same sources. Malformed files/records are
skipped with logs, never fatal.

    python -m keisei_tpu_torch.sl.prepare SOURCES... --output-dir DIR [--device cuda]
"""

from __future__ import annotations

import argparse
import logging
from pathlib import Path

from .dataset import write_meta, write_shard
from .encode import GameEncoder
from .parsers import GameFilter, GameRecord, build_parser_registry

logger = logging.getLogger(__name__)


def _iter_game_files(sources: list[str], registry) -> list[Path]:
    files: list[Path] = []
    for source in sources:
        p = Path(source)
        if p.is_file():
            files.append(p)
        elif p.is_dir():
            for ext in registry:
                files.extend(sorted(p.glob(f"*{ext}")))
                if ext.upper() != ext:
                    files.extend(sorted(p.glob(f"*{ext.upper()}")))
    return files


def prepare_sl_data(
    game_sources: list[str],
    output_dir: str,
    min_ply: int = 40,
    min_rating: int | None = None,
    shard_size: int = 100_000,
    batch_games: int = 64,
    num_channels: int = 50,
    device: str = "cuda",
) -> dict:
    if num_channels != 50:
        # the shard record format is fixed at 50x81 f32 observations
        # (dataset.py RECORD layout, byte-compatible with the reference);
        # fail before hours of parsing/encoding, not at the first
        # write_shard assertion
        raise ValueError(
            f"shard format is fixed at 50 observation channels, got "
            f"num_channels={num_channels} (the 46-channel mode is an env "
            f"observation mode, not an SL shard format)"
        )
    out = Path(output_dir)
    out.mkdir(parents=True, exist_ok=True)
    for stale in out.glob("shard_*.bin"):
        stale.unlink()
    if (out / "shard_meta.json").exists():
        (out / "shard_meta.json").unlink()

    registry = build_parser_registry()
    game_filter = GameFilter(min_ply=min_ply, min_rating=min_rating)
    files = _iter_game_files(game_sources, registry)
    logger.info("found %d game files", len(files))

    records: list[GameRecord] = []
    games_parsed = games_filtered = parse_errors = 0
    for f in files:
        parser = registry.get(f.suffix.lower())
        if parser is None:
            continue
        try:
            for rec in parser.parse(f):
                games_parsed += 1
                if game_filter.accepts(rec):
                    records.append(rec)
                else:
                    games_filtered += 1
        except Exception:
            logger.exception("failed to parse %s — skipping file", f)
            parse_errors += 1

    encoder = GameEncoder(num_channels=num_channels, batch_games=batch_games,
                          device=device)
    shard_counts: list[int] = []
    pending = None
    total_positions = 0
    enc_stats = {"dropped_moves": 0, "dropped_games": 0}

    def flush(obs, pol, val, sc):
        nonlocal total_positions
        write_shard(out / f"shard_{len(shard_counts):05d}.bin", obs, pol, val, sc)
        shard_counts.append(len(pol))
        total_positions += len(pol)

    import numpy as np

    for start in range(0, len(records), batch_games * 4):
        chunk = records[start : start + batch_games * 4]
        obs, pol, val, sc, stats = encoder.encode_games(chunk)
        enc_stats["dropped_moves"] += stats["dropped_moves"]
        enc_stats["dropped_games"] += stats["dropped_games"]
        if pending is not None:
            obs = np.concatenate([pending[0], obs])
            pol = np.concatenate([pending[1], pol])
            val = np.concatenate([pending[2], val])
            sc = np.concatenate([pending[3], sc])
        while len(pol) >= shard_size:
            flush(obs[:shard_size], pol[:shard_size], val[:shard_size],
                  sc[:shard_size])
            obs, pol, val, sc = (obs[shard_size:], pol[shard_size:],
                                 val[shard_size:], sc[shard_size:])
        pending = (obs, pol, val, sc)

    if pending is not None and len(pending[1]) > 0:
        flush(*pending)

    summary = {
        "games_parsed": games_parsed,
        "games_filtered": games_filtered,
        "parse_errors": parse_errors,
        "positions": total_positions,
        **enc_stats,
    }
    write_meta(out, shard_counts, placeholder=False, extra=summary)
    logger.info("SL prepare: %s", summary)
    return summary


def main(argv=None):
    p = argparse.ArgumentParser(description="keisei_tpu_torch SL data preparation")
    p.add_argument("sources", nargs="+", help="game files or directories")
    p.add_argument("--output-dir", required=True)
    p.add_argument("--min-ply", type=int, default=40)
    p.add_argument("--min-rating", type=int, default=None)
    p.add_argument("--shard-size", type=int, default=100_000)
    p.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO, force=True)
    prepare_sl_data(
        args.sources, args.output_dir, min_ply=args.min_ply,
        min_rating=args.min_rating, shard_size=args.shard_size,
        device=args.device,
    )


if __name__ == "__main__":
    main()

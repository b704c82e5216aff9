"""Supervised-learning pipeline (counterpart of keisei_tpu/sl/): parsers and
shards (copies), the batched encoder on the port's engine, the trainer."""

from .dataset import SCORE_NORMALIZATION, SLDataset, write_meta, write_shard
from .encode import GameEncoder, usi_to_action
from .parsers import (
    CSAParser,
    GameFilter,
    GameOutcome,
    GameParser,
    GameRecord,
    ParsedMove,
    SFENParser,
    build_parser_registry,
)
from .prepare import prepare_sl_data
from .trainer import SLConfig, SLTrainer

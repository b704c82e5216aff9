"""Game-record parsers for supervised learning data.

Input-format contract matches the reference (keisei/sl/parsers.py:15-405):
a simple SFEN/USI block format (metadata line(s), position line, one USI
move per line) and the public CSA V2.2 format used by Floodgate, converted
to USI. Parsers are registered by extension; malformed records are skipped
with a log, never fatal.
"""

from __future__ import annotations

import logging
import re
from abc import ABC, abstractmethod
from dataclasses import dataclass, field
from enum import Enum
from pathlib import Path
from typing import Iterator

logger = logging.getLogger(__name__)

# Metadata keys a parser may emit that carry a player-strength figure.
# GameFilter consults all of them; a single weak player disqualifies a game.
_RATING_KEYS = ("rating", "black_rating", "white_rating")

# A metadata line is "key: value" where the key carries no digits — this is
# what separates it from USI moves ("7g7f") and SFEN position strings, both
# of which always contain digits before any ':' could appear.
_META_LINE = re.compile(r"^(?P<key>[^:\d]+):(?P<val>.*)$")


class GameOutcome(Enum):
    WIN_BLACK = "win_black"
    WIN_WHITE = "win_white"
    DRAW = "draw"


@dataclass
class ParsedMove:
    move_usi: str
    sfen_before: str = ""


@dataclass
class GameRecord:
    moves: list[ParsedMove]
    outcome: GameOutcome
    metadata: dict[str, str] = field(default_factory=dict)
    start_sfen: str = ""  # "" = standard start position


@dataclass
class GameFilter:
    """Quality gate before encoding (format contract: reference
    keisei/sl/parsers.py:34-49 — same thresholds and rating keys, so the
    same corpora survive filtering in both frameworks)."""

    min_ply: int = 40
    min_rating: int | None = None

    def accepts(self, record: GameRecord) -> bool:
        if len(record.moves) < self.min_ply:
            return False
        if self.min_rating is None:
            return True
        # Only cleanly-numeric ratings count; absent or unparseable ones
        # never disqualify a game (the corpus may predate rating tags).
        reported = (record.metadata.get(k, "") for k in _RATING_KEYS)
        return all(int(r) >= self.min_rating for r in reported if r.isdigit())


class GameParser(ABC):
    @abstractmethod
    def parse(self, path: Path) -> Iterator[GameRecord]: ...

    @abstractmethod
    def supported_extensions(self) -> set[str]: ...


class SFENParser(GameParser):
    """Blank-line-separated blocks: metadata lines (result: required),
    a position line (startpos | SFEN), then one USI move per line."""

    def supported_extensions(self) -> set[str]:
        return {".sfen"}

    def parse(self, path: Path) -> Iterator[GameRecord]:
        text = path.read_text().replace("\r\n", "\n").replace("\r", "\n")
        for block in text.strip().split("\n\n"):
            record = self._parse_block(block)
            if record is not None:
                yield record

    @staticmethod
    def _parse_block(block: str) -> GameRecord | None:
        lines = [ln.strip() for ln in block.splitlines() if ln.strip()]
        if len(lines) < 2:
            return None

        # Leading run of metadata lines, then the position line, then moves.
        metadata: dict[str, str] = {}
        body = iter(enumerate(lines))
        pos_line = "startpos"
        rest_at = len(lines)
        for i, ln in body:
            m = _META_LINE.match(ln)
            if m is None:
                pos_line, rest_at = ln, i + 1
                break
            metadata[m["key"].strip()] = m["val"].strip()

        try:
            outcome = GameOutcome(metadata.get("result", ""))
        except ValueError:
            return None  # unknown/absent result — unusable for labels

        moves = [ParsedMove(move_usi=ln) for ln in lines[rest_at:]]
        if not moves:
            return None
        return GameRecord(
            moves=moves,
            outcome=outcome,
            metadata=metadata,
            start_sfen="" if pos_line == "startpos" else pos_line,
        )


class CSAParser(GameParser):
    """CSA V2.2 (Floodgate) records, converted to USI moves.

    Promotion detection tracks the board: a destination piece that is a
    promoted type while the source was not means '+' (parsers.py:164-205).
    """

    _RANKS = "abcdefghi"
    _TO_USI = {"FU": "P", "KY": "L", "KE": "N", "GI": "S", "KI": "G",
               "KA": "B", "HI": "R", "TO": "P", "NY": "L", "NK": "N",
               "NG": "S", "UM": "B", "RY": "R", "OU": "K"}
    _PROMOTED = {"TO", "NY", "NK", "NG", "UM", "RY"}

    def supported_extensions(self) -> set[str]:
        return {".csa"}

    @classmethod
    def _initial_board(cls, with_color: bool = False) -> dict[tuple[int, int], str]:
        """Standard start as {(col,row): name}; with_color prefixes the
        CSA side sign ('-' gote rows 1-3, '+' sente rows 7-9) so the
        standard-start guard cannot be fooled by a board with the right
        pieces on the right squares but the wrong owners (review r2)."""
        board: dict[tuple[int, int], str] = {}
        back = ["KY", "KE", "GI", "KI", "OU", "KI", "GI", "KE", "KY"]
        for i, name in enumerate(back):
            board[(9 - i, 1)] = name
            board[(9 - i, 9)] = name
        board[(8, 2)] = "HI"
        board[(2, 2)] = "KA"
        board[(8, 8)] = "KA"
        board[(2, 8)] = "HI"
        for col in range(1, 10):
            board[(col, 3)] = "FU"
            board[(col, 7)] = "FU"
        if with_color:
            board = {(c, r): ("-" if r <= 3 else "+") + name
                     for (c, r), name in board.items()}
        return board

    @classmethod
    def _parse_p_lines(cls, p_lines: list[str],
                       with_color: bool = False) -> dict[tuple[int, int], str]:
        board: dict[tuple[int, int], str] = {}
        for ln in p_lines:
            if len(ln) < 3 or not ln[1].isdigit():
                continue
            row = int(ln[1])
            content = ln[2:]
            for i in range(9):
                cell = content[i * 3 : i * 3 + 3]
                if len(cell) < 3 or cell.strip() in ("*", ""):
                    continue
                board[(9 - i, row)] = cell if with_color else cell[1:3]
        return board

    def _move_to_usi(self, csa: str, board: dict[tuple[int, int], str]) -> str:
        body = csa[1:]
        fc, fr, tc, tr = int(body[0]), int(body[1]), int(body[2]), int(body[3])
        piece = body[4:6]
        if fc == 0 and fr == 0:
            return f"{self._TO_USI.get(piece, piece)}*{tc}{self._RANKS[tr - 1]}"
        usi = f"{fc}{self._RANKS[fr - 1]}{tc}{self._RANKS[tr - 1]}"
        src = board.get((fc, fr), "")
        if piece in self._PROMOTED and src not in self._PROMOTED:
            usi += "+"
        return usi

    def parse(self, path: Path) -> Iterator[GameRecord]:
        text = path.read_text(errors="replace").replace("\r\n", "\n")
        # multiple games may be separated by "/" lines (CSA spec)
        for chunk in text.split("\n/\n"):
            record = self._parse_one(chunk)
            if record is not None:
                yield record

    def _parse_one(self, text: str) -> GameRecord | None:
        metadata: dict[str, str] = {}
        p_lines: list[str] = []
        moves: list[ParsedMove] = []
        outcome: GameOutcome | None = None
        board: dict[tuple[int, int], str] | None = None
        use_initial = False
        nonstandard: str | None = None

        for ln in text.split("\n"):
            ln = ln.strip()
            if not ln or ln.startswith("'"):
                # comments; ratings often hide here ('black_rate:...:2345)
                if ln.startswith("'") and "rate" in ln.lower() and ":" in ln:
                    parts = ln[1:].split(":")
                    if len(parts) >= 3 and parts[-1].split(".")[0].isdigit():
                        key = "black_rating" if "black" in parts[0].lower() else "white_rating"
                        metadata[key] = parts[-1].split(".")[0]
                continue
            if ln.startswith("N+"):
                metadata["black"] = ln[2:]
            elif ln.startswith("N-"):
                metadata["white"] = ln[2:]
            elif ln == "PI":
                use_initial = True
            elif ln.startswith("PI"):
                # "PI82HI22KA" = initial position with pieces REMOVED
                # (handicap). GameRecord carries no custom start position
                # yet, and the encoder replays from the standard startpos —
                # encoding this game would silently label observations of
                # the WRONG board. Skip it loudly instead.
                nonstandard = f"handicap start {ln!r}"
            elif ln.startswith(("P+", "P-")):
                # pieces placed in hand / scattered (tsume or handicap)
                nonstandard = f"custom piece placement {ln!r}"
            elif ln.startswith("P") and len(ln) > 1 and ln[1].isdigit():
                p_lines.append(ln)
            elif ln in ("+", "-"):
                continue  # side-to-move marker
            elif ln.startswith(("+", "-")) and len(ln) >= 7:
                if board is None:
                    board = (self._parse_p_lines(p_lines) if p_lines
                             else self._initial_board())
                try:
                    usi = self._move_to_usi(ln, board)
                except (ValueError, IndexError):
                    logger.warning("bad CSA move %r — skipping game", ln)
                    return None
                moves.append(ParsedMove(move_usi=usi))
                body = ln[1:]
                fc, fr = int(body[0]), int(body[1])
                tc, tr = int(body[2]), int(body[3])
                if (fc, fr) in board:
                    del board[(fc, fr)]
                board[(tc, tr)] = body[4:6]
            elif ln.startswith("%"):
                n = len(moves)
                if ln in ("%TORYO", "%TIME_UP"):
                    # resignation / flag fall: the side TO MOVE loses (no
                    # move is recorded for them, unlike %ILLEGAL_MOVE)
                    outcome = (GameOutcome.WIN_WHITE if n % 2 == 0
                               else GameOutcome.WIN_BLACK)
                elif ln in ("%SENNICHITE", "%JISHOGI", "%HIKIWAKE", "%CHUDAN"):
                    outcome = GameOutcome.DRAW
                elif ln == "%TSUMI":
                    outcome = (GameOutcome.WIN_WHITE if n % 2 == 0
                               else GameOutcome.WIN_BLACK)
                elif ln == "%ILLEGAL_MOVE":
                    # the offending move IS recorded: the last mover loses
                    outcome = (GameOutcome.WIN_BLACK if n % 2 == 0
                               else GameOutcome.WIN_WHITE)
                elif ln == "%KACHI":  # declaration win by the mover to act
                    outcome = (GameOutcome.WIN_BLACK if n % 2 == 0
                               else GameOutcome.WIN_WHITE)
        if use_initial and board is None:
            pass  # game with no moves
        if nonstandard is None and p_lines:
            # explicit P1..P9 board: accept only if it IS the standard
            # start (some exporters spell it out); anything else is a
            # custom position the encoder cannot replay yet
            if (self._parse_p_lines(p_lines, with_color=True)
                    != self._initial_board(with_color=True)):
                nonstandard = "P1..P9 board differs from the standard start"
        if nonstandard is not None:
            logger.warning("skipping CSA game with non-standard start "
                           "position (%s) — the SL encoder replays from "
                           "the standard startpos", nonstandard)
            return None
        if not moves or outcome is None:
            return None
        return GameRecord(moves=moves, outcome=outcome, metadata=metadata)


def build_parser_registry() -> dict[str, GameParser]:
    registry: dict[str, GameParser] = {}
    for parser in (SFENParser(), CSAParser()):
        for ext in parser.supported_extensions():
            registry[ext] = parser
    return registry

"""SFEN parse / serialize (host-side, numpy).

The port's own copy of keisei_tpu/engine/sfen.py, numpy only, so that the port never
imports the JAX package; tests/test_torch_copies.py holds the two equal.

Conventions match the reference (shogi-core/src/sfen.rs:93-320):
  * board rows listed top (row 0, White's camp) to bottom; uppercase = Black,
    '+' prefix = promoted; digits = run of empty squares.
  * hands: Black then White in R,B,G,S,N,L,P order, count prefix when > 1,
    '-' if both empty. Parse accepts any letter order and multi-digit counts.
  * serialized move number is always 1 (positions carry no history).
"""

from __future__ import annotations

import numpy as np

from .types import BISHOP, EMPTY, GOLD, KING, KNIGHT, LANCE, PAWN, ROOK, SILVER

STARTPOS_SFEN = "lnsgkgsnl/1r5b1/ppppppppp/9/9/9/PPPPPPPPP/1B5R1/LNSGKGSNL b - 1"

_LETTER_TO_KIND = {
    "p": PAWN, "l": LANCE, "n": KNIGHT, "s": SILVER,
    "g": GOLD, "b": BISHOP, "r": ROOK, "k": KING,
}
_KIND_TO_LETTER = {v: k for k, v in _LETTER_TO_KIND.items()}
_HAND_ORDER = [ROOK, BISHOP, GOLD, SILVER, KNIGHT, LANCE, PAWN]


class SfenError(ValueError):
    pass


# total piece supply per hand type: a count beyond this is corrupt input;
# it would also overflow the Zobrist hand table (19 slots)
from .types import HAND_MAX as _HAND_LIMIT  # noqa: E402


def parse_sfen(sfen: str) -> tuple[np.ndarray, np.ndarray, int]:
    """Parse to (board (81,) int8, hands (2,7) int8, stm)."""
    parts = sfen.split()
    if len(parts) < 3:
        raise SfenError(f"expected at least 3 fields, got {len(parts)}: {sfen!r}")
    board_str, side_str, hands_str = parts[0], parts[1], parts[2]

    rows = board_str.split("/")
    if len(rows) != 9:
        raise SfenError(f"expected 9 ranks, got {len(rows)}")
    board = np.full(81, EMPTY, dtype=np.int8)
    for r, row in enumerate(rows):
        c = 0
        promoted = False
        for ch in row:
            if ch == "+":
                promoted = True
                continue
            if ch.isdigit():
                if promoted:
                    raise SfenError(f"'+' before digit in rank {r}")
                c += int(ch)
                continue
            lower = ch.lower()
            if lower not in _LETTER_TO_KIND:
                raise SfenError(f"bad piece char {ch!r}")
            if c >= 9:
                raise SfenError(f"rank {r} overflows 9 files")
            kind = _LETTER_TO_KIND[lower]
            if promoted:
                if kind in (GOLD, KING):
                    raise SfenError(f"cannot promote {ch!r}")
                kind += 8
            color = 0 if ch.isupper() else 1
            board[r * 9 + c] = kind + 16 * color
            c += 1
            promoted = False
        if c != 9:
            raise SfenError(f"rank {r} has {c} files, expected 9")
        if promoted:
            raise SfenError(f"dangling '+' at end of rank {r}")

    if side_str == "b":
        stm = 0
    elif side_str == "w":
        stm = 1
    else:
        raise SfenError(f"bad side-to-move {side_str!r}")

    hands = np.zeros((2, 7), dtype=np.int8)
    if hands_str != "-":
        count = 0
        for ch in hands_str:
            if ch.isdigit():
                count = count * 10 + int(ch)
                continue
            lower = ch.lower()
            if lower not in _LETTER_TO_KIND or lower == "k":
                raise SfenError(f"bad hand char {ch!r}")
            color = 0 if ch.isupper() else 1
            n = int(hands[color, _LETTER_TO_KIND[lower]]) + max(count, 1)
            if n > _HAND_LIMIT[_LETTER_TO_KIND[lower]]:
                raise SfenError(
                    f"hand count {n} for {ch!r} exceeds the piece supply "
                    f"({_HAND_LIMIT[_LETTER_TO_KIND[lower]]})")
            hands[color, _LETTER_TO_KIND[lower]] = n
            count = 0
        if count:
            raise SfenError("trailing count in hands")

    return board, hands, stm


def parse_sfen_move_number(sfen: str) -> int | None:
    """Optional 4th SFEN field: the 1-based number of the NEXT move.

    The reference discards it (sfen.rs:186 'parts[3] is the move number —
    we ignore it'), which leaves a seeded spectator game's ply plane at 0
    and grants it a full max_ply of extra moves. Returns None when absent
    or malformed (lenient: the field is informational)."""
    parts = sfen.split()
    if len(parts) >= 4 and parts[3].isdigit() and int(parts[3]) >= 1:
        return int(parts[3])
    return None


def to_sfen(board: np.ndarray, hands: np.ndarray, stm: int) -> str:
    rows = []
    for r in range(9):
        row = ""
        run = 0
        for c in range(9):
            cell = int(board[r * 9 + c])
            if cell < 0:
                run += 1
                continue
            if run:
                row += str(run)
                run = 0
            kind, color = cell % 16, cell // 16
            promoted = kind >= 8
            letter = _KIND_TO_LETTER[kind - 8 if promoted else kind]
            if color == 0:
                letter = letter.upper()
            row += ("+" if promoted else "") + letter
        if run:
            row += str(run)
        rows.append(row)

    hands_str = ""
    for color in range(2):
        for hp in _HAND_ORDER:
            cnt = int(hands[color, hp])
            if cnt > 0:
                if cnt > 1:
                    hands_str += str(cnt)
                letter = _KIND_TO_LETTER[hp]
                hands_str += letter.upper() if color == 0 else letter

    return "/".join(rows) + f" {'b' if stm == 0 else 'w'} {hands_str or '-'} 1"

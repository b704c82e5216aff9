"""Spectator-facing conversions: USI + Hodges notation, board/hands dicts.

The port's own copy of keisei_tpu/env/spectator_data.py, numpy only, so that the port never
imports the JAX package; tests/test_torch_copies.py holds the two equal.

Host-side numpy (no jax): this layer feeds the observability DB and the
WebUI, matching the reference's spectator data formats exactly
(shogi-gym/src/spectator_data.rs:45-233) — piece dicts with
type/color/promoted/row/col, hands as {color: {piece: count}}, USI move
strings ("7g7f", "8h2b+", "P*5e"), and Hodges notation with minimal
disambiguation ("P-7f", "Bx3c", "S-4d=", "G6g-5h").
"""

from __future__ import annotations

import numpy as np

from ..engine import tables as T
from ..engine import types as TY
from ..engine.sfen import to_sfen

PIECE_NAME = {
    TY.PAWN: "pawn", TY.LANCE: "lance", TY.KNIGHT: "knight",
    TY.SILVER: "silver", TY.GOLD: "gold", TY.BISHOP: "bishop",
    TY.ROOK: "rook", TY.KING: "king",
}
PIECE_CHAR = {
    TY.PAWN: "P", TY.LANCE: "L", TY.KNIGHT: "N", TY.SILVER: "S",
    TY.GOLD: "G", TY.BISHOP: "B", TY.ROOK: "R", TY.KING: "K",
}
RESULT_NAME = {
    TY.NOT_TERMINATED: "in_progress",
    TY.CHECKMATE: "checkmate",
    TY.REPETITION: "repetition",
    TY.PERPETUAL_CHECK: "perpetual_check",
    TY.IMPASSE: "impasse",
    TY.MAX_MOVES: "max_moves",
}


def square_usi(sq: int) -> str:
    """USI square string: file 1-9 from the right, rank a-i from the top."""
    r, c = divmod(int(sq), 9)
    return f"{9 - c}{chr(ord('a') + r)}"


def decode_action_np(action: int, stm: int):
    """Spatial action -> absolute-space (is_drop, from, to, promote, piece).

    Host-numpy mirror of engine.core.decode_action (semantics:
    spatial_action_mapper.rs:136-271). `piece` is the hand index for drops.
    """
    sq, slot = divmod(int(action), 139)
    if slot >= 132:
        to = 80 - sq if stm == 1 else sq
        return True, -1, to, False, slot - 132
    if slot >= 128:
        k = slot - 128
        dest = int(T.KNIGHT_TO[0][sq, k // 2])
        promote = bool(k % 2)
    else:
        promote = slot >= 64
        base = slot - 64 if promote else slot
        d, dist = divmod(base, 8)
        dest = int(T.RAY[d, sq, dist])
    if stm == 1:
        return False, 80 - sq, 80 - dest, promote, -1
    return False, sq, dest, promote, -1


def move_usi(action: int, stm: int) -> str:
    is_drop, frm, to, promote, piece = decode_action_np(action, stm)
    if is_drop:
        return f"{PIECE_CHAR[piece]}*{square_usi(to)}"
    return f"{square_usi(frm)}{square_usi(to)}{'+' if promote else ''}"


def _spatial_dests(from_pspace: int) -> np.ndarray:
    """(139,) perspective-space destination per slot for a source square
    (-1 where off-board); drops use the source square itself."""
    dests = np.full(139, -1, dtype=np.int32)
    rays = T.RAY[:, from_pspace, :]  # (8, 8)
    dests[:64] = rays.reshape(64)
    dests[64:128] = rays.reshape(64)
    kn = T.KNIGHT_TO[0][from_pspace]  # (2,)
    dests[128:132] = np.repeat(kn, 2)
    dests[132:] = from_pspace
    return dests


def move_notation(
    action: int, board: np.ndarray, stm: int, legal_mask: np.ndarray | None = None
) -> str:
    """Hodges notation with minimal disambiguation.

    `legal_mask` is the (81, 139) or flat (11259,) perspective-space mask of
    the mover; when provided, other same-type pieces that can also reach the
    destination trigger file/rank/full-square disambiguation
    (spectator_data.rs:109-186).
    """
    is_drop, frm, to, promote, piece = decode_action_np(action, stm)
    if is_drop:
        return f"{PIECE_CHAR[piece]}*{square_usi(to)}"

    cell = int(board[frm])
    if cell < 0:
        return f"?{square_usi(frm)}-{square_usi(to)}"
    kind = cell % 16
    promoted = kind >= 8
    base = kind - 8 if promoted else kind
    prefix = ("+" if promoted else "") + PIECE_CHAR[base]

    disambig = ""
    if base != TY.KING and legal_mask is not None:
        mask = np.asarray(legal_mask).reshape(81, 139)
        to_p = 80 - to if stm == 1 else to
        frm_p = 80 - frm if stm == 1 else frm
        others = []
        for f_p in range(81):
            if f_p == frm_p or not mask[f_p, :132].any():
                continue
            f_abs = 80 - f_p if stm == 1 else f_p
            other_cell = int(board[f_abs])
            if other_cell < 0 or other_cell % 16 != kind:
                continue
            if (_spatial_dests(f_p)[:132] == to_p)[mask[f_p, :132]].any():
                others.append(f_abs)
        if others:
            fr, fc = divmod(frm, 9)
            same_file = any(o % 9 == fc for o in others)
            same_rank = any(o // 9 == fr for o in others)
            if not same_file:
                disambig = str(9 - fc)
            elif not same_rank:
                disambig = chr(ord("a") + fr)
            else:
                disambig = square_usi(frm)

    sep = "x" if int(board[to]) >= 0 else "-"

    if promote or _is_forced_promotion(base, to, stm, promoted):
        suffix = "+"
    elif _could_promote(base, promoted, frm, to, stm):
        suffix = "="
    else:
        suffix = ""
    return f"{prefix}{disambig}{sep}{square_usi(to)}{suffix}"


def _zone_rows(stm: int):
    return range(0, 3) if stm == 0 else range(6, 9)


def _is_forced_promotion(base: int, to: int, stm: int, promoted: bool) -> bool:
    if promoted:
        return False
    row = to // 9
    last = 0 if stm == 0 else 8
    if base in (TY.PAWN, TY.LANCE):
        return row == last
    if base == TY.KNIGHT:
        return abs(row - last) <= 1
    return False


def _could_promote(base: int, promoted: bool, frm: int, to: int, stm: int) -> bool:
    if promoted or not T.CAN_PROMOTE_KIND[base]:
        return False
    zone = _zone_rows(stm)
    return (frm // 9 in zone) or (to // 9 in zone)


def build_spectator_dict(
    board: np.ndarray,
    hands: np.ndarray,
    stm: int,
    ply: int,
    reason: int,
    winner: int,
    in_check: bool,
    move_history: list[str] | None = None,
) -> dict:
    """Reference-format spectator dict (spectator_data.rs:190-233)."""
    board_list: list[dict | None] = []
    for sq in range(81):
        cell = int(board[sq])
        if cell < 0:
            board_list.append(None)
            continue
        kind, color = cell % 16, cell // 16
        promoted = kind >= 8
        base = kind - 8 if promoted else kind
        board_list.append({
            "type": PIECE_NAME[base],
            "color": "black" if color == 0 else "white",
            "promoted": promoted,
            "row": sq // 9,
            "col": sq % 9,
        })
    hands_dict = {
        ("black" if color == 0 else "white"): {
            PIECE_NAME[hp]: int(hands[color, hp]) for hp in range(7)
        }
        for color in range(2)
    }
    return {
        "board": board_list,
        "hands": hands_dict,
        "current_player": "black" if stm == 0 else "white",
        "ply": int(ply),
        "is_over": reason != TY.NOT_TERMINATED,
        "result": RESULT_NAME.get(int(reason), "in_progress"),
        "sfen": to_sfen(board, hands, stm),
        "in_check": bool(in_check),
        "move_history": list(move_history or []),
    }

"""Batched shogi rules core in PyTorch (counterpart of keisei_tpu/engine/core.py).

Every function takes a leading batch dimension N where the JAX module took
a single environment and was vmapped. Legality is the same dense (81, 139)
perspective-space action mask; the geometry comes from the numpy tables of
`engine/tables.py` (the port's copy of the JAX package's tables), copied
to the device once (`EngineTables`).

The JAX module reformulates every per-square lookup as a one-hot matmul for
the TPU's matrix unit. Here lookups are plain gathers, and the slider
floods are ray walks (gather along each ray, cumulative blocking, one
scatter-by-matmul back to squares): a handful of kernels instead of 64
shifts per flood. Outputs are identical, bit for bit.

The Zobrist hash is one int64 per position (the JAX engine's two uint32
lanes, low lane in the low bits): CUDA has XOR and comparison for int64
but not for uint32. `hash_lanes` converts back for comparisons.
"""

from __future__ import annotations

from dataclasses import dataclass, fields, replace

import numpy as np
import torch

from . import tables as T
from . import types as TY
from . import zobrist as Z
from ..utils.device import resolve_device


def _lanes_to_i64(lanes: np.ndarray) -> np.ndarray:
    """(..., 2) uint32 lanes -> (...) int64 with lane 1 in the high bits."""
    lo = lanes[..., 0].astype(np.uint64)
    hi = lanes[..., 1].astype(np.uint64)
    return (lo | (hi << np.uint64(32))).view(np.int64)


def hash_lanes(h: torch.Tensor | np.ndarray) -> np.ndarray:
    """int64 hashes -> (..., 2) uint32 lanes, the JAX engine's layout."""
    u = np.asarray(h.cpu() if isinstance(h, torch.Tensor) else h).astype(np.int64).view(np.uint64)
    return np.stack([(u & np.uint64(0xFFFFFFFF)).astype(np.uint32),
                     (u >> np.uint64(32)).astype(np.uint32)], axis=-1)


# FROM_RAY[from, dir, k] = destination at distance k+1, or -1 (81, 8, 8)
_FROM_RAY = np.transpose(T.RAY, (1, 0, 2)).astype(np.int64)


def _ray_dest_onehot() -> np.ndarray:
    """(81*64, 81) f32: ray slot (s, d, k) -> its destination square."""
    oh = np.zeros((81 * 64, 81), np.float32)
    dests = _FROM_RAY.reshape(-1)
    ok = dests >= 0
    oh[np.arange(81 * 64)[ok], dests[ok]] = 1.0
    return oh


class EngineTables:
    """Device copies of the rule geometry, built once per device (the card
    unless the caller names "cpu"; "cuda" without a card raises)."""

    def __init__(self, device: torch.device | str = "cuda"):
        dev = resolve_device(device)
        self.device = dev

        def t(a, dtype=None):
            return torch.as_tensor(np.ascontiguousarray(a), device=dev, dtype=dtype)

        self.ar81 = torch.arange(81, device=dev)
        self.from_ray_valid = t(_FROM_RAY >= 0)                         # (81,8,8)
        self.from_ray_c = t(np.maximum(_FROM_RAY, 0))                   # (81,8,8)
        self.ray_dest = t(_ray_dest_onehot())                           # (5184,81)
        self.step_att = t(T.STEP_ATT)                                   # (16,2,81,81)
        self.slide_ok = t(T.SLIDE_OK)                                   # (16,2,8)
        guard = np.zeros((16, 2, 1), bool)
        self.slide_ok_g = t(np.concatenate([T.SLIDE_OK, guard], axis=2))  # (16,2,9)
        self.aligned_dir = t(T.ALIGNED_DIR.astype(np.int64))           # (81,81)
        self.between = t(T.BETWEEN)                                     # (81,81,81)
        self.between_flat = t(T.BETWEEN.reshape(81 * 81, 81).astype(np.float32))
        self.move_ok = t(T.MOVE_OK)                                     # (16,8,8)
        kto = T.KNIGHT_TO[0].astype(np.int64)                           # (81,2)
        self.k_valid = t(kto >= 0)
        self.k_dest_c = t(np.maximum(kto, 0))
        dest_c = np.maximum(_FROM_RAY, 0)
        self.row0_at_dest = t((T.ROW_OF[dest_c] == 0) & (_FROM_RAY >= 0))
        self.zone_at_dest = t(T.IN_PROMO_ZONE[dest_c] & (_FROM_RAY >= 0))
        kdc = np.maximum(kto, 0)
        self.k_row01 = t((T.ROW_OF[kdc] <= 1) & (kto >= 0))
        self.k_zone = t(T.IN_PROMO_ZONE[kdc] & (kto >= 0))
        self.in_promo_zone = t(T.IN_PROMO_ZONE)
        self.can_promote_kind = t(T.CAN_PROMOTE_KIND)
        self.dead_drop_t = t(T.DEAD_DROP.T)                             # (81,7)
        self.row_of = t(T.ROW_OF.astype(np.int64))
        self.col_of = t(T.COL_OF.astype(np.int64))
        self.knight_to0 = t(T.KNIGHT_TO[0].astype(np.int64))
        self.obs_channel = t(T.OBS_CHANNEL.astype(np.int64))
        self.hand_max = t(TY.HAND_MAX.astype(np.float32))
        self.impasse_value = t(TY.IMPASSE_VALUE.astype(np.int64))
        self.hand_impasse_value = t(TY.HAND_IMPASSE_VALUE.astype(np.int64))
        self.piece_value = t(TY.PIECE_VALUE.astype(np.int64))
        self.hand_value = t(TY.HAND_VALUE.astype(np.int64))
        self.z_piece = t(_lanes_to_i64(Z.Z_PIECE))                      # (32,81)
        self.z_hand = t(_lanes_to_i64(Z.Z_HAND))                        # (2,7,19)
        self.z_stm = int(_lanes_to_i64(Z.Z_STM))
        self.startpos = t(T.STARTPOS_BOARD)


@dataclass
class GameState:
    """Batched game state (absolute space); every field has leading dim N."""

    board: torch.Tensor       # (N, 81) int8: -1 empty, else kind + 16*color
    hands: torch.Tensor       # (N, 2, 7) int8
    stm: torch.Tensor         # (N,) int8: 0 Black, 1 White
    ply: torch.Tensor         # (N,) int32
    hash_: torch.Tensor       # (N,) int64
    hash_hist: torch.Tensor   # (N, H) int64: position hash at each past ply
    check_hist: torch.Tensor  # (N, H) bool
    in_check: torch.Tensor    # (N,) bool
    reason: torch.Tensor      # (N,) int8
    winner: torch.Tensor      # (N,) int8

    def map(self, fn) -> "GameState":
        return GameState(**{f.name: fn(getattr(self, f.name)) for f in fields(self)})


def select_envs(mask: torch.Tensor, new, old):
    """Per env, `new` where `mask` else `old`: a GameState, or a tensor
    with a leading N."""
    def sel(a, b):
        return torch.where(mask.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)

    if isinstance(new, torch.Tensor):
        return sel(new, old)
    return type(new)(**{f.name: sel(getattr(new, f.name), getattr(old, f.name))
                        for f in fields(new)})


def init_state(n: int, max_ply: int, tb: EngineTables) -> GameState:
    """N fresh start positions with H = max_ply + 1 history slots."""
    dev = tb.device
    h0 = int(_lanes_to_i64(Z.compute_hash(T.STARTPOS_BOARD, np.zeros((2, 7), np.int8), 0)))
    H = max_ply + 1
    return GameState(
        board=tb.startpos.expand(n, 81).clone(),
        hands=torch.zeros((n, 2, 7), dtype=torch.int8, device=dev),
        stm=torch.zeros(n, dtype=torch.int8, device=dev),
        ply=torch.zeros(n, dtype=torch.int32, device=dev),
        hash_=torch.full((n,), h0, dtype=torch.int64, device=dev),
        hash_hist=torch.zeros((n, H), dtype=torch.int64, device=dev),
        check_hist=torch.zeros((n, H), dtype=torch.bool, device=dev),
        in_check=torch.zeros(n, dtype=torch.bool, device=dev),
        reason=torch.full((n,), TY.NOT_TERMINATED, dtype=torch.int8, device=dev),
        winner=torch.full((n,), TY.WINNER_NONE, dtype=torch.int8, device=dev),
    )


def state_from_position(board, hands, stm, max_ply: int, tb: EngineTables,
                        ply: int = 0) -> GameState:
    """A batch of one from an absolute-space numpy position (SFEN fixtures),
    `ply` plies into its game (no history before it)."""
    st = init_state(1, max_ply, tb)
    h = int(_lanes_to_i64(Z.compute_hash(board, hands, int(stm))))
    dev = tb.device
    return replace(
        st,
        board=torch.as_tensor(np.asarray(board, np.int8), device=dev)[None],
        hands=torch.as_tensor(np.asarray(hands, np.int8), device=dev)[None],
        stm=torch.full((1,), int(stm), dtype=torch.int8, device=dev),
        ply=torch.full((1,), int(ply), dtype=torch.int32, device=dev),
        hash_=torch.full((1,), h, dtype=torch.int64, device=dev),
    )


# ---------------------------------------------------------------------------
# Perspective canonicalization
# ---------------------------------------------------------------------------


def perspective_board(board: torch.Tensor, stm: torch.Tensor) -> torch.Tensor:
    """Flip 180 degrees and swap colours where White is to move. (N,81) int8."""
    flipped = torch.flip(board, dims=(1,))
    swapped = torch.where(flipped >= 0, flipped ^ 16, flipped)
    return torch.where((stm == 0)[:, None], board, swapped)


def _ray_attacks(sliders: torch.Tensor, empty: torch.Tensor, tb: EngineTables) -> torch.Tensor:
    """Squares attacked along rays. sliders (N, 8, 81) per-direction
    presence, empty (N, 81) -> (N, 81) bool. Same set as the JAX flood: a
    ray square is reached when every square before it on the ray is empty."""
    n = empty.shape[0]
    e_at = empty[:, tb.from_ray_c] & tb.from_ray_valid                 # (N,81,8,8)
    blocked = torch.cumsum((~e_at).to(torch.int32), dim=-1)
    clear = torch.ones_like(e_at)
    clear[..., 1:] = blocked[..., :-1] == 0
    reach = sliders.transpose(1, 2)[..., None] & tb.from_ray_valid & clear
    return (reach.reshape(n, 81 * 64).float() @ tb.ray_dest) > 0.5


def _step_attacks(kind: torch.Tensor, present: torch.Tensor, side: int,
                  tb: EngineTables) -> torch.Tensor:
    """(N, 81) bool squares step-attacked by the `present` pieces of `side`."""
    att = tb.step_att[kind, side, tb.ar81[None, :]]                    # (N,81s,81t)
    return (att & present[:, :, None]).any(dim=1)


def _dir_gather(table9: torch.Tensor, dirs: torch.Tensor) -> torch.Tensor:
    """table9 (N, 81, 9) slide capability per square incl. the guard column;
    dirs (N, 81) direction or -1 -> table9[n, s, dir or guard]."""
    idx = torch.where(dirs >= 0, dirs, torch.full_like(dirs, 8))
    return torch.gather(table9, 2, idx[:, :, None])[:, :, 0]


# ---------------------------------------------------------------------------
# Legal move mask (perspective space)
# ---------------------------------------------------------------------------


def legal_mask_pspace(pboard: torch.Tensor, own_hand: torch.Tensor, tb: EngineTables):
    """(mask (N, 81, 139) bool, in_check (N,), n_check (N,)) for (N, 81)
    perspective boards and (N, 7) mover hands."""
    n = pboard.shape[0]
    dev = pboard.device
    ar = torch.arange(n, device=dev)
    own = (pboard >= 0) & (pboard < 16)
    opp = pboard >= 16
    occ = own | opp
    empty = ~occ
    kind = (pboard & 15).long()                       # empty -> 15 (unused kind)
    is_king = kind == TY.KING

    own_king = own & is_king
    opp_king = opp & is_king
    has_king = own_king.any(dim=1)
    has_oking = opp_king.any(dim=1)
    ksq = own_king.to(torch.uint8).argmax(dim=1)
    oksq = opp_king.to(torch.uint8).argmax(dim=1)

    kslide1 = tb.slide_ok_g[kind, 1]                  # (N,81,9)
    kslide0 = tb.slide_ok_g[kind, 0]

    # --- opponent attacks with x-ray through our king (for king moves) ---
    opp_steps = _step_attacks(kind, opp, 1, tb)
    opp_sliders = tb.slide_ok[kind, 1].transpose(1, 2) & opp[:, None, :]   # (N,8,81)
    empty_x = empty | (tb.ar81[None, :] == ksq[:, None])
    opp_att_x = opp_steps | _ray_attacks(opp_sliders, empty_x, tb)

    # --- checkers on our king ---
    step_check = opp & tb.step_att[kind, 1, tb.ar81[None, :], ksq[:, None]] & has_king[:, None]
    aligned_to_k = tb.aligned_dir[tb.ar81[None, :], ksq[:, None]]         # (N,81) dir f->ksq
    btw_to_k = tb.between[tb.ar81[None, :], ksq[:, None]]                 # (N,81f,81t)
    btw_to_k_blocked = (btw_to_k & occ[:, None, :]).any(dim=2)
    slide_cap = _dir_gather(kslide1, aligned_to_k)
    slide_check = opp & slide_cap & ~btw_to_k_blocked & has_king[:, None]
    checkers = step_check | slide_check
    n_check = checkers.sum(dim=1)
    in_check = n_check > 0

    block = (slide_check[:, :, None] & btw_to_k).any(dim=1)
    check_dest = checkers | block
    single = (n_check == 1)[:, None]
    nonking_allowed = torch.where(in_check[:, None], single & check_dest,
                                  torch.ones_like(check_dest))

    # --- pins ---
    d_ks = tb.aligned_dir[ksq]                                            # (N,81) dir ksq->s
    d_ks = torch.where(has_king[:, None], d_ks, torch.full_like(d_ks, -1))
    btw_occ = (occ.float() @ tb.between_flat.T).reshape(n, 81, 81) > 0.5  # (N,81s,81t)
    king_to_s_clear = ~btw_occ[ar, ksq]                                   # (N,81)
    same_dir = tb.aligned_dir[None] == d_ks[:, :, None]                   # (N,81s,81t)
    pdir = torch.where(d_ks >= 0, (d_ks + 4) % 8, torch.full_like(d_ks, 8))
    pinner_match = torch.gather(kslide1.transpose(1, 2), 1,
                                pdir[:, :, None].expand(n, 81, 81))       # [n,s,t]=kslide1[n,t,pdir[n,s]]
    pin_t = same_dir & opp[:, None, :] & pinner_match & ~btw_occ
    pinned = own & ~is_king & (d_ks >= 0) & king_to_s_clear & pin_t.any(dim=2)

    # --- per-destination lookups ---
    fr, valid = tb.from_ray_c, tb.from_ray_valid
    empty_at = empty[:, fr] & valid                                       # (N,81,8,8)
    own_at = own[:, fr] & valid
    att_at = opp_att_x[:, fr] & valid
    allow_at = nonking_allowed[:, fr] & valid
    dks1 = d_ks + 1
    dks_at = torch.where(valid, dks1[:, fr], torch.zeros_like(dks1[:, fr]))

    blocked_before = torch.cumsum((~empty_at).to(torch.int32), dim=-1)
    path_clear = torch.ones_like(empty_at)
    path_clear[..., 1:] = blocked_before[..., :-1] == 0
    move_cap = tb.move_ok[kind] & own[:, :, None, None]
    base = move_cap & valid & path_clear & ~own_at

    is_king_from = own_king
    pin_ok_at = ~pinned[:, :, None, None] | (dks_at == dks1[:, :, None, None])
    nk_dest_ok = allow_at & pin_ok_at
    legal_bd = base & torch.where(is_king_from[:, :, None, None], ~att_at, nk_dest_ok)

    is_pl = own & ((kind == TY.PAWN) | (kind == TY.LANCE))
    is_kn = own & (kind == TY.KNIGHT)
    must = is_pl[:, :, None, None] & tb.row0_at_dest
    canp = tb.can_promote_kind[kind] & own
    zone_from = tb.in_promo_zone
    promo_opt = canp[:, :, None, None] & (zone_from[None, :, None, None] | tb.zone_at_dest)
    slots_nopromo = legal_bd & ~must
    slots_promo = legal_bd & (must | promo_opt) & canp[:, :, None, None]

    # --- knight slots 128-131 ---
    kd, kv = tb.k_dest_c, tb.k_valid
    k_own_at = own[:, kd] & kv
    k_allow_at = nonking_allowed[:, kd] & kv
    k_dks_at = torch.where(kv, dks1[:, kd], torch.zeros_like(dks1[:, kd]))
    k_pin_ok = ~pinned[:, :, None] | (k_dks_at == dks1[:, :, None])
    kbase = is_kn[:, :, None] & kv & ~k_own_at & k_allow_at & k_pin_ok
    kzone = zone_from[:, None] | tb.k_zone
    knight_nopromo = kbase & ~tb.k_row01
    knight_promo = kbase & (tb.k_row01 | kzone)

    # --- drops: slots 132-138 ---
    has_piece = own_hand > 0
    drop_ok = empty[:, :, None] & has_piece[:, None, :] & ~tb.dead_drop_t
    drop_allowed = torch.where(in_check[:, None], single & block, torch.ones_like(block))
    drop_ok = drop_ok & drop_allowed[:, :, None]
    own_pawn = (own & (kind == TY.PAWN)).reshape(n, 9, 9).any(dim=1)     # (N,9) per file
    nifu = own_pawn[:, tb.col_of]
    pawn_drop_ok = drop_ok[:, :, TY.PAWN] & ~nifu

    ufz_possible = (oksq // 9) < 8
    ufz_sq = oksq + 9
    ufz = _uchi_fu_zume(kind, own, opp, occ, empty, oksq, torch.clamp(ufz_sq, max=80),
                        kslide1, kslide0, tb) | ~has_oking
    pawn_drop_ok = pawn_drop_ok & ~(
        (tb.ar81[None, :] == ufz_sq[:, None]) & (ufz & ufz_possible)[:, None])
    drop_ok = drop_ok.clone()
    drop_ok[:, :, TY.PAWN] = pawn_drop_ok

    knight_part = torch.stack([knight_nopromo[..., 0], knight_promo[..., 0],
                               knight_nopromo[..., 1], knight_promo[..., 1]], dim=2)
    mask = torch.cat([slots_nopromo.reshape(n, 81, 64), slots_promo.reshape(n, 81, 64),
                      knight_part, drop_ok], dim=2)
    return mask, in_check, n_check


def _uchi_fu_zume(kind, own, opp, occ, empty, oksq, c, kslide1, kslide0,
                  tb: EngineTables) -> torch.Tensor:
    """(N,) bool: a pawn dropped at c (= oksq + 9) would mate.

    Replicates rules.rs:19-162 with its quirks, as the JAX engine does: the
    king-escape test uses our attack map with the king still in place, and
    a capture only counts if the dropper no longer attacks the king after it.
    """
    n = kind.shape[0]
    ar = torch.arange(n, device=kind.device)
    c_mask = tb.ar81[None, :] == c[:, None]
    occ_p = occ | c_mask
    empty_p = empty & ~c_mask
    oksq_mask = tb.ar81[None, :] == oksq[:, None]

    own_steps = _step_attacks(kind, own, 0, tb)
    own_sliders = tb.slide_ok[kind, 0].transpose(1, 2) & own[:, None, :]
    own_att_p = own_steps | oksq_mask | _ray_attacks(own_sliders, empty_p, tb)

    # 1. king escape to an adjacent square not held by a defender or attacked
    adj = tb.step_att[TY.KING, 0][oksq]                                   # (N,81)
    king_escape = (adj & ~opp & ~own_att_p).any(dim=1)

    # 2. a non-king defender captures the pawn
    cand_step = opp & tb.step_att[kind, 1, tb.ar81[None, :], c[:, None]]
    cap_to_c = _dir_gather(kslide1, tb.aligned_dir[tb.ar81[None, :], c[:, None]])
    btw_to_c = tb.between[tb.ar81[None, :], c[:, None]]                   # (N,81f,81t)
    blocked_to_c = (btw_to_c & occ_p[:, None, :]).any(dim=2)
    cand_slide = opp & cap_to_c & ~blocked_to_c
    cand = (cand_step | cand_slide) & (kind != TY.KING) & opp

    # after the capture (defender leaves t), do we still attack the king?
    step_att_on_k = own_steps[ar, oksq]                                   # (N,)
    slider_cap_ok = _dir_gather(kslide0, tb.aligned_dir[tb.ar81[None, :], oksq[:, None]])
    s_aligned = own & slider_cap_ok
    btw_to_ok = tb.between[tb.ar81[None, :], oksq[:, None]]               # (N,81s,81t)
    contains_t = btw_to_ok & occ_p[:, None, :]
    b0 = contains_t.sum(dim=2)
    clear_after = (b0[:, :, None] - contains_t.long()) == 0
    slide_att_on_k_t = (s_aligned[:, :, None] & clear_after).any(dim=1)  # (N,81t)
    att_on_k_after = step_att_on_k[:, None] | slide_att_on_k_t
    capture_escape = (cand & ~att_on_k_after).any(dim=1)
    return ~king_escape & ~capture_escape


# ---------------------------------------------------------------------------
# Action decode + apply (absolute space, incremental Zobrist)
# ---------------------------------------------------------------------------


def decode_action(action: torch.Tensor, stm: torch.Tensor, tb: EngineTables):
    """(is_drop, from_abs, to_abs, promote, drop_piece), each (N,)."""
    action = action.long()
    sq, slot = action // 139, action % 139
    is_drop = slot >= 132
    is_knight = (slot >= 128) & (slot < 132)
    s_promote = (slot >= 64) & (slot < 128)
    s_base = torch.where(s_promote, slot - 64, slot)
    s_dir = torch.clamp(s_base // 8, 0, 7)
    s_dist = s_base % 8
    slide_dest = tb.from_ray_c[sq, s_dir, s_dist]
    k = torch.clamp(slot - 128, 0, 3)
    knight_dest = torch.clamp(tb.knight_to0[sq, k // 2], min=0)
    p_to = torch.where(is_drop, sq, torch.where(is_knight, knight_dest, slide_dest))
    promote = torch.where(is_knight, (k % 2) == 1, s_promote) & ~is_drop
    flip = stm.long() == 1
    from_abs = torch.where(flip, 80 - sq, sq)
    to_abs = torch.where(flip, 80 - p_to, p_to)
    drop_piece = torch.clamp(slot - 132, 0, 6)
    return is_drop, from_abs, to_abs, promote, drop_piece


def apply_action(state: GameState, action: torch.Tensor, tb: EngineTables) -> GameState:
    """Apply one (legal) action per env; returns a new state. Every index
    is kept in range whatever the action (an illegal one, as a replayed
    record may hold, gives a state of no meaning but never a fault): the
    clamps below change nothing for a legal move."""
    n = state.board.shape[0]
    ar = torch.arange(n, device=state.board.device)
    stm = state.stm.long()
    board, hands = state.board, state.hands
    is_drop, from_abs, to_abs, promote, drop_piece = decode_action(action, state.stm, tb)

    cell = board[ar, from_abs].long()
    cell_c = torch.clamp(cell, min=0)
    captured = board[ar, to_abs].long()
    cap_valid = ~is_drop & (captured >= 0)
    captured_c = torch.clamp(captured, min=0)
    cap_kind = captured_c & 15
    cap_base = torch.clamp(torch.where(cap_kind >= 8, cap_kind - 8, cap_kind), max=6)

    placed = torch.clamp(torch.where(is_drop, drop_piece + 16 * stm,
                                     torch.where(promote, cell_c + 8, cell_c)), max=31)

    new_board = board.clone()
    new_board[ar, from_abs] = torch.where(is_drop, board[ar, from_abs],
                                          torch.full_like(board[ar, from_abs], TY.EMPTY))
    new_board[ar, to_abs] = placed.to(torch.int8)

    old_cap = torch.clamp(hands[ar, stm, cap_base].long(), min=0)
    old_drop = torch.clamp(hands[ar, stm, drop_piece].long(), min=0)
    new_hands = hands.clone()
    new_hands[ar, stm, cap_base] += cap_valid.to(torch.int8)
    new_hands[ar, stm, drop_piece] -= is_drop.to(torch.int8)

    zp, zh = tb.z_piece, tb.z_hand
    zero = torch.zeros_like(state.hash_)
    h = state.hash_
    h = h ^ torch.where(is_drop, zero, zp[cell_c, from_abs])
    h = h ^ torch.where(cap_valid, zp[captured_c, to_abs], zero)
    h = h ^ zp[placed, to_abs]
    h = h ^ torch.where(cap_valid, zh[stm, cap_base, torch.clamp(old_cap, max=18)]
                        ^ zh[stm, cap_base, torch.clamp(old_cap + 1, max=18)], zero)
    h = h ^ torch.where(is_drop, zh[stm, drop_piece, torch.clamp(old_drop, max=18)]
                        ^ zh[stm, drop_piece, torch.clamp(old_drop - 1, 0, 18)], zero)
    h = h ^ tb.z_stm

    ply = state.ply.long()
    hash_hist = state.hash_hist.clone()
    hash_hist[ar, ply] = state.hash_
    check_hist = state.check_hist.clone()
    check_hist[ar, ply] = state.in_check
    return replace(state, board=new_board, hands=new_hands,
                   stm=(1 - stm).to(torch.int8), ply=state.ply + 1, hash_=h,
                   hash_hist=hash_hist, check_hist=check_hist)


# ---------------------------------------------------------------------------
# Rules: repetition, impasse, material
# ---------------------------------------------------------------------------


def repetition_info(state: GameState):
    """(count incl. current, perpetual-check flag), each (N,)."""
    H = state.hash_hist.shape[1]
    past = torch.arange(H, device=state.ply.device)[None, :] < state.ply[:, None]
    match = past & (state.hash_hist == state.hash_[:, None])
    count = 1 + match.sum(dim=1)
    perpetual = match.any(dim=1) & (~match | state.check_hist).all(dim=1)
    return count, perpetual


def impasse_check(board: torch.Tensor, hands: torch.Tensor, tb: EngineTables):
    """CSA 24-point impasse. Returns (active (N,), winner (N,) int8)."""
    kind = (board & 15).long()
    black = (board >= 0) & (board < 16)
    white = board >= 16
    row = tb.row_of[None, :]
    king = kind == TY.KING
    bk_in = (black & king & (row <= 2)).any(dim=1)
    wk_in = (white & king & (row >= 6)).any(dim=1)
    cnt_b = (black & (row <= 2)).sum(dim=1)
    cnt_w = (white & (row >= 6)).sum(dim=1)
    vals = tb.impasse_value[kind]
    hv = tb.hand_impasse_value
    sb = torch.where(black, vals, 0).sum(dim=1) + (hands[:, 0].long() * hv).sum(dim=1)
    sw = torch.where(white, vals, 0).sum(dim=1) + (hands[:, 1].long() * hv).sum(dim=1)
    active = bk_in & wk_in & (cnt_b >= 10) & (cnt_w >= 10) & ((sb >= 24) | (sw >= 24))
    winner = torch.where((sb >= 24) & (sw >= 24), TY.WINNER_NONE,
                         torch.where(sb >= 24, 0, 1)).to(torch.int8)
    return active, winner


def material_balance(board: torch.Tensor, hands: torch.Tensor, perspective: torch.Tensor,
                     tb: EngineTables) -> torch.Tensor:
    """Standard-value material balance from `perspective`, (N,) int64."""
    kind = (board & 15).long()
    vals = tb.piece_value[kind]
    color = (board >= 16).long()
    p = perspective.long()
    sign = torch.where(color == p[:, None], 1, -1)
    bal = torch.where(board >= 0, vals * sign, 0).sum(dim=1)
    ar = torch.arange(board.shape[0], device=board.device)
    hv = tb.hand_value
    return bal + (hands[ar, p].long() * hv).sum(dim=1) - (hands[ar, 1 - p].long() * hv).sum(dim=1)


# ---------------------------------------------------------------------------
# Observation encoding (perspective space)
# ---------------------------------------------------------------------------


def observe(pboard, hands, stm, ply, max_ply: int, rep_count, in_check,
            num_channels: int, tb: EngineTables) -> torch.Tensor:
    """46/50-channel observation (N, C, 81) float32."""
    n = pboard.shape[0]
    dev = pboard.device
    ch_of = torch.where(pboard >= 0, tb.obs_channel[(pboard & 31).long()], -1)
    piece = (ch_of[:, None, :] == torch.arange(28, device=dev)[None, :, None]).float()
    ar = torch.arange(n, device=dev)
    p = stm.long()
    own_hand = hands[ar, p].float() / tb.hand_max
    opp_hand = hands[ar, 1 - p].float() / tb.hand_max
    ones = torch.ones((n, 1, 81), dtype=torch.float32, device=dev)
    hand = torch.cat([own_hand, opp_hand], dim=1)[:, :, None] * ones
    indicator = (p == 0).float()[:, None, None] * ones
    # XLA folds a division by a constant into a multiply by its f32
    # reciprocal; doing the same keeps the plane bit-identical
    inv_max = float(np.float32(1.0) / np.float32(max_ply))
    move_count = torch.clamp(ply.float() * inv_max, 0.0, 1.0)[:, None, None] * ones
    planes = [piece, hand, indicator, move_count]
    if num_channels == 46:
        planes.append(torch.zeros((n, 2, 81), dtype=torch.float32, device=dev))
    else:
        prior = rep_count - 1
        rep = torch.stack([prior == 1, prior == 2, prior == 3, prior >= 4], dim=1).float()
        planes += [rep[:, :, None] * ones, in_check.float()[:, None, None] * ones,
                   torch.zeros((n, 1, 81), dtype=torch.float32, device=dev)]
    return torch.cat(planes, dim=1)


# ---------------------------------------------------------------------------
# Full environment step
# ---------------------------------------------------------------------------


@dataclass
class StepOutput:
    obs: torch.Tensor           # (N, C, 81) f32, post-reset
    legal_mask: torch.Tensor    # (N, 11259) bool, post-reset
    reward: torch.Tensor        # (N,) f32, last-mover perspective
    terminated: torch.Tensor    # (N,) bool
    truncated: torch.Tensor     # (N,) bool
    terminal_obs: torch.Tensor  # (N, C, 81) f32, pre-reset
    current_player: torch.Tensor  # (N,) int8, post-reset
    captured: torch.Tensor      # (N,) uint8: hand-piece index or 255
    term_reason: torch.Tensor   # (N,) uint8
    ply_count: torch.Tensor     # (N,) int32, pre-reset
    material: torch.Tensor      # (N,) int32, last-mover perspective


def position_status(s1: GameState, mask1_flat: torch.Tensor, max_ply: int, tb: EngineTables):
    """(reason, winner, rep_count) for just-reached positions. Order: max-ply
    -> sennichite/perpetual -> impasse -> checkmate (game.rs:460-499)."""
    last_mover = (1 - s1.stm.long()).to(torch.int8)
    rep_count, perpetual = repetition_info(s1)
    imp_active, imp_winner = impasse_check(s1.board, s1.hands, tb)
    no_moves = ~mask1_flat.any(dim=1)
    i8 = lambda v: torch.full_like(s1.reason, v)  # noqa: E731
    reason = torch.where(no_moves, i8(TY.CHECKMATE), i8(TY.NOT_TERMINATED))
    winner = torch.where(no_moves, last_mover, i8(TY.WINNER_NONE))
    reason = torch.where(imp_active, i8(TY.IMPASSE), reason)
    winner = torch.where(imp_active, imp_winner, winner)
    rep_hit = rep_count >= 4
    reason = torch.where(rep_hit, torch.where(perpetual, i8(TY.PERPETUAL_CHECK),
                                              i8(TY.REPETITION)), reason)
    winner = torch.where(rep_hit, torch.where(perpetual, s1.stm, i8(TY.WINNER_NONE)), winner)
    hit_max = s1.ply >= max_ply
    reason = torch.where(hit_max, i8(TY.MAX_MOVES), reason)
    winner = torch.where(hit_max, i8(TY.WINNER_NONE), winner)
    return reason, winner, rep_count


def env_step(state: GameState, action: torch.Tensor, reset_state: GameState,
             reset_obs: torch.Tensor, reset_mask: torch.Tensor, num_channels: int,
             tb: EngineTables) -> tuple[GameState, StepOutput]:
    """One batched step: apply, termination check, auto-reset of done envs.

    reset_state/reset_obs/reset_mask are the fresh-game state (batch of one
    or N) and its outputs, selected wherever an env finished.
    """
    n = state.board.shape[0]
    ar = torch.arange(n, device=state.board.device)
    max_ply = state.hash_hist.shape[1] - 1
    last_mover = state.stm

    is_drop, _, to_abs, _, _ = decode_action(action, state.stm, tb)
    pre_target = state.board[ar, to_abs].long()
    cap_kind = pre_target & 15
    cap_base = torch.clamp(torch.where(cap_kind >= 8, cap_kind - 8, cap_kind), max=6)
    captured_meta = torch.where(~is_drop & (pre_target >= 0), cap_base, 255).to(torch.uint8)

    s1 = apply_action(state, action, tb)
    pboard1 = perspective_board(s1.board, s1.stm)
    own_hand1 = s1.hands[ar, s1.stm.long()]
    mask1, in_check1, _ = legal_mask_pspace(pboard1, own_hand1, tb)
    mask1_flat = mask1.reshape(n, -1)

    reason, winner, rep_count = position_status(s1, mask1_flat, max_ply, tb)
    truncated = reason == TY.MAX_MOVES
    terminated = (reason != TY.NOT_TERMINATED) & ~truncated
    done = terminated | truncated

    reward = torch.where(winner >= 0, torch.where(winner == last_mover, 1.0, -1.0),
                         0.0).float()
    material = material_balance(s1.board, s1.hands, last_mover, tb).to(torch.int32)
    obs1 = observe(pboard1, s1.hands, s1.stm, s1.ply, max_ply, rep_count, in_check1,
                   num_channels, tb)
    s1 = replace(s1, in_check=in_check1, reason=reason, winner=winner)

    def sel(fresh, cur):
        d = done.reshape((n,) + (1,) * (cur.dim() - 1))
        return torch.where(d, fresh.to(cur.dtype), cur)

    new_state = GameState(**{f.name: sel(getattr(reset_state, f.name), getattr(s1, f.name))
                             for f in fields(GameState)})
    out_obs = sel(reset_obs, obs1)
    out_mask = sel(reset_mask, mask1_flat)
    return new_state, StepOutput(
        obs=out_obs, legal_mask=out_mask, reward=reward, terminated=terminated,
        truncated=truncated, terminal_obs=obs1, current_player=new_state.stm,
        captured=captured_meta, term_reason=reason.to(torch.uint8),
        ply_count=s1.ply, material=material,
    )


def initial_outputs(state: GameState, num_channels: int, tb: EngineTables):
    """(obs (N,C,81), legal_mask (N,11259), in_check (N,)) for fresh states."""
    n = state.board.shape[0]
    ar = torch.arange(n, device=state.board.device)
    pboard = perspective_board(state.board, state.stm)
    mask, in_check, _ = legal_mask_pspace(pboard, state.hands[ar, state.stm.long()], tb)
    rep_count, _ = repetition_info(state)
    max_ply = state.hash_hist.shape[1] - 1
    obs = observe(pboard, state.hands, state.stm, state.ply, max_ply, rep_count, in_check,
                  num_channels, tb)
    return obs, mask.reshape(n, -1), in_check

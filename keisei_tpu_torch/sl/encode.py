"""The position encoder: batched game replay on the port's engine
(counterpart of keisei_tpu/sl/encode.py).

G games replay in lockstep on one device: per ply, over all games at
once, the perspective board, the legal mask, the repetition count, the
observation, the material balance and the legality of the played move,
then `apply_action`. A game past its length stays on its frozen state
(field by field `torch.where(active, new, old)`, history included), so its
repetition counts never see positions it did not reach. The outputs stay
on the device until the chunk is done and are copied to the host once.

The value category and the score target (`mat / 76.0`) are computed on the
host with numpy, as the JAX package does, so that shards written from
either encoder are byte-identical. USI -> spatial action conversion is
pure geometry (the spatial action space is perspective-relative).
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch

from ..engine import core as C
from ..engine import types as TY
from ..utils.device import resolve_device
from .parsers import GameOutcome, GameRecord

_DIR_INDEX = {tuple(d): i for i, d in enumerate(TY.DIRECTIONS.tolist())}
_PIECE_OF_CHAR = {"P": 0, "L": 1, "N": 2, "S": 3, "G": 4, "B": 5, "R": 6}


def usi_square(token: str) -> int:
    """'7g' -> absolute square index (row-major, row 0 = rank a)."""
    file, rank = int(token[0]), ord(token[1]) - ord("a")
    return rank * 9 + (9 - file)


def usi_to_action(usi: str, stm: int) -> int:
    """USI move -> spatial action id for the side to move.

    Raises ValueError for malformed/ungeometric moves.
    """
    if "*" in usi:
        piece = _PIECE_OF_CHAR[usi[0].upper()]
        to_abs = usi_square(usi[2:4])
        sq = 80 - to_abs if stm == 1 else to_abs
        return sq * 139 + 132 + piece
    frm_abs, to_abs = usi_square(usi[0:2]), usi_square(usi[2:4])
    promote = usi.endswith("+")
    if stm == 1:
        frm, to = 80 - frm_abs, 80 - to_abs
    else:
        frm, to = frm_abs, to_abs
    dr, dc = to // 9 - frm // 9, to % 9 - frm % 9
    if (dr, dc) == (-2, -1):
        return frm * 139 + 128 + (1 if promote else 0)
    if (dr, dc) == (-2, 1):
        return frm * 139 + 130 + (1 if promote else 0)
    dist = max(abs(dr), abs(dc))
    if dist == 0:
        raise ValueError(f"null move {usi!r}")
    step = (dr // dist, dc // dist)
    if step not in _DIR_INDEX or (dr, dc) != (step[0] * dist, step[1] * dist):
        raise ValueError(f"ungeometric move {usi!r}")
    slot = _DIR_INDEX[step] * 8 + (dist - 1) + (64 if promote else 0)
    return frm * 139 + slot


def _value_cat(outcome: GameOutcome, black_to_move: bool) -> int:
    if outcome == GameOutcome.WIN_BLACK:
        return 0 if black_to_move else 2
    if outcome == GameOutcome.WIN_WHITE:
        return 2 if black_to_move else 0
    return 1


def _replay(actions: torch.Tensor, lengths: torch.Tensor, state: C.GameState,
            num_channels: int, max_ply: int, tb: C.EngineTables):
    """(G, L) actions from G start states -> per-ply observations (L, G, C,
    81), legality of the played move (L, G) and the mover's material
    balance (L, G), all on the device."""
    G, L = actions.shape
    dev = actions.device
    ar = torch.arange(G, device=dev)
    obs_out = torch.empty((L, G, num_channels, 81), dtype=torch.float32, device=dev)
    legal_out = torch.empty((L, G), dtype=torch.bool, device=dev)
    mat_out = torch.empty((L, G), dtype=torch.int64, device=dev)
    for t in range(L):
        pboard = C.perspective_board(state.board, state.stm)
        own_hand = state.hands[ar, state.stm.long()]
        mask, in_check, _ = C.legal_mask_pspace(pboard, own_hand, tb)
        rep, _ = C.repetition_info(state)
        obs_out[t] = C.observe(pboard, state.hands, state.stm, state.ply, max_ply, rep,
                               in_check, num_channels, tb)
        mat_out[t] = C.material_balance(state.board, state.hands, state.stm, tb)
        a = actions[:, t]
        legal = mask.reshape(G, -1).gather(1, a[:, None])[:, 0]
        active = lengths > t
        legal_out[t] = legal & active
        state = C.select_envs(active, C.apply_action(state, a, tb), state)
    return obs_out, legal_out, mat_out


class GameEncoder:
    """Batched encoder: records -> (obs, policy, value, score) arrays, on
    `device` (the card unless the caller names "cpu"; "cuda" without a
    card raises)."""

    def __init__(self, num_channels: int = 50, max_ply: int = 512,
                 batch_games: int = 64, device: torch.device | str = "cuda"):
        self.num_channels = num_channels
        self.max_ply = max_ply
        self.batch_games = batch_games
        self.device = resolve_device(device)
        self.tables = C.EngineTables(self.device)

    def _start_states(self, starts: list[tuple]) -> C.GameState:
        """A batch of G fresh states with each game's own start position."""
        dev = self.device
        st = C.init_state(len(starts), self.max_ply, self.tables)
        return replace(
            st,
            board=torch.as_tensor(np.stack([s[0] for s in starts]).astype(np.int8), device=dev),
            hands=torch.as_tensor(np.stack([s[1] for s in starts]).astype(np.int8), device=dev),
            stm=torch.as_tensor(np.array([s[2] for s in starts], np.int8), device=dev),
            hash_=torch.as_tensor(C._lanes_to_i64(np.stack([s[3] for s in starts])),
                                  device=dev))

    def encode_games(self, records: list[GameRecord]):
        """Returns (observations (P, C*81) f32, policy (P,) i64,
        value (P,) i64, score (P,) f32, stats dict). Positions whose played
        move fails the engine's legality mask are dropped (data hygiene)."""
        all_obs, all_pol, all_val, all_score = [], [], [], []
        dropped_moves = dropped_games = 0

        from ..engine import tables as T
        from ..engine.sfen import parse_sfen
        from ..engine.zobrist import compute_hash

        b0, h0 = T.STARTPOS_BOARD, np.zeros((2, 7), np.int8)
        hash0 = np.asarray(compute_hash(b0, h0, 0))

        for start in range(0, len(records), self.batch_games):
            chunk = records[start : start + self.batch_games]
            acts, lens, outcomes, starts = [], [], [], []
            for rec in chunk:
                if getattr(rec, "start_sfen", ""):
                    try:
                        sb, sh, sstm = parse_sfen(rec.start_sfen)
                    except Exception:
                        dropped_games += 1
                        continue
                    start_state = (sb, sh, sstm,
                                   np.asarray(compute_hash(sb, sh, sstm)))
                else:
                    start_state = (b0, h0, 0, hash0)
                stm0 = start_state[2]
                try:
                    ids = [
                        usi_to_action(m.move_usi, (stm0 + i) % 2)
                        for i, m in enumerate(rec.moves[: self.max_ply - 1])
                    ]
                except (ValueError, KeyError, IndexError):
                    dropped_games += 1
                    continue
                acts.append(ids)
                lens.append(len(ids))
                outcomes.append(rec.outcome)
                starts.append(start_state)
            if not acts:
                continue
            # bucket L to multiples of 64, as the JAX encoder does
            L = -(-max(lens) // 64) * 64
            G = len(acts)
            a = np.zeros((G, L), dtype=np.int32)
            for g, ids in enumerate(acts):
                a[g, : len(ids)] = ids
            obs, legal, mat = _replay(
                torch.as_tensor(a.astype(np.int64), device=self.device),
                torch.as_tensor(np.array(lens, np.int64), device=self.device),
                self._start_states(starts), self.num_channels, self.max_ply, self.tables)
            obs = obs.cpu().numpy()  # (L, G, C, 81): one copy per chunk
            legal = legal.cpu().numpy()
            mat = mat.cpu().numpy().astype(np.int32)

            for g in range(G):
                n_ok = 0
                for t in range(lens[g]):
                    if not legal[t, g]:
                        dropped_moves += lens[g] - t
                        break  # replay diverged; drop the tail
                    all_obs.append(obs[t, g].reshape(-1))
                    all_pol.append(a[g, t])
                    all_val.append(
                        _value_cat(outcomes[g], (starts[g][2] + t) % 2 == 0))
                    # score target: material balance from the mover's view
                    all_score.append(mat[t, g] / 76.0)
                    n_ok += 1
                if n_ok == 0:
                    dropped_games += 1

        stats = {
            "positions": len(all_pol),
            "dropped_moves": dropped_moves,
            "dropped_games": dropped_games,
        }
        if not all_pol:
            return (np.zeros((0, self.num_channels * 81), np.float32),
                    np.zeros(0, np.int64), np.zeros(0, np.int64),
                    np.zeros(0, np.float32), stats)
        return (
            np.stack(all_obs).astype(np.float32),
            np.array(all_pol, np.int64),
            np.array(all_val, np.int64),
            np.array(all_score, np.float32),
            stats,
        )

"""A plain reference of the shogi rules, for the engine's transitions: apply a
move (captures to hand, drops, promotion), flip the turn, list the legal
moves, end the game, and encode the position as the model's input planes.

It is written from the rules of shogi and from what the configuration's
engine states about its interface, and imports nothing of the program:

- Actions: 81 x 139 in the mover's perspective (the board turned 180
  degrees for White, so that the mover always plays north). An action is
  `square * 139 + slot`: slots 0-63 a move from `square` in direction
  `dir` (N, NE, E, SE, S, SW, W, NW; north is row - 1) by `dist` squares,
  `dir * 8 + dist - 1`; slots 64-127 the same with promotion; 128-131 a
  knight's jump from `square`, left or right (column -1 or +1), without or
  with promotion (128 left, 129 left+, 130 right, 131 right+); 132-138 a
  drop on `square` of a piece in hand (pawn, lance, knight, silver, gold,
  bishop, rook).
- Legality: the mover's king is not left attacked; a pawn, lance or knight
  promotes where it would have no further move; a promotion is possible
  for an unpromoted pawn, lance, knight, silver, bishop or rook moving into,
  out of or within the last three ranks; no drop where the piece would
  have no move; no second unpromoted pawn on a file (nifu); no pawn drop
  that mates (uchi-fu-zume: the opponent would have no legal move).
- Game end, the later taking precedence: no legal move (the side to move
  loses); the impasse rule below; the fourth occurrence of a position in
  the game (a draw, or where the side to move was in check at each earlier
  occurrence, perpetual check: the checking side loses); `max_ply` plies
  (truncated, not terminated). A finished game restarts from the initial
  position. The reward is the last mover's: +1 won, -1 lost, 0 otherwise.
- Impasse, as the engine states it: both kings in the opponent's three
  ranks, each side with ten or more of its pieces there (the king counted),
  and a side with 24 points or more (rooks and bishops, promoted or not, 5;
  the king 0; every other piece 1; on the whole board and in hand) wins;
  both, a draw.
- Material (the score target), from the last mover's side: pawn 1, lance
  3, knight 4, silver 5, gold 6, bishop 8, rook 10, king 0, promoted pawn
  7, lance 6, knight 6, silver 6, bishop 10, rook 12; pieces in hand at
  their unpromoted value.
- Planes (50 x 81, float32, the mover's perspective): 0-7 the mover's
  pawn, lance, knight, silver, gold, bishop, rook, king; 8-13 its promoted
  pawn, lance, knight, silver, bishop, rook; 14-27 the opponent's, in the
  same order; 28-34 the mover's pieces in hand over 18, 4, 4, 4, 4, 2, 2;
  35-41 the opponent's; 42 ones where Black is to move; 43 the ply over
  `max_ply` (float32, at most 1); 44-47 the position's earlier occurrences
  in the game: one, two, three, four or more; 48 ones where the mover is
  in check; 49 zeros.

Squares are row * 9 + column, row 0 the far rank from Black. A cell is
empty (-1) or `kind + 16 * colour`: kinds 0-7 pawn, lance, knight, silver,
gold, bishop, rook, king, and 8-11, 13, 14 the promoted pawn, lance,
knight, silver, bishop, rook; colour 0 Black (first to move), 1 White.
"""

from __future__ import annotations

import numpy as np

PAWN, LANCE, KNIGHT, SILVER, GOLD, BISHOP, ROOK, KING = range(8)
EMPTY = -1
HAND_MAX = np.array([18, 4, 4, 4, 4, 2, 2], dtype=np.float32)
SLOTS = 139
ACTIONS = 81 * SLOTS
PLANES = 50

# the mover's directions, north first, clockwise: (drow, dcol)
DIRS = ((-1, 0), (-1, 1), (0, 1), (1, 1), (1, 0), (1, -1), (0, -1), (-1, -1))
_N, _NE, _E, _SE, _S, _SW, _W, _NW = range(8)
_GOLD = (_N, _NE, _NW, _E, _W, _S)
_STEPS = {PAWN: (_N,), SILVER: (_N, _NE, _NW, _SE, _SW), GOLD: _GOLD, KING: tuple(range(8)),
          8: _GOLD, 9: _GOLD, 10: _GOLD, 11: _GOLD, 13: (_N, _E, _S, _W),
          14: (_NE, _SE, _SW, _NW)}
_SLIDES = {LANCE: (_N,), BISHOP: (_NE, _SE, _SW, _NW), ROOK: (_N, _E, _S, _W),
           13: (_NE, _SE, _SW, _NW), 14: (_N, _E, _S, _W)}
# REACH[kind][dir]: how far a piece of `kind` moves that way (the mover's)
REACH = [[8 if d in _SLIDES.get(k, ()) else 1 if d in _STEPS.get(k, ()) else 0
          for d in range(8)] for k in range(16)]
CAN_PROMOTE = (PAWN, LANCE, KNIGHT, SILVER, BISHOP, ROOK)
VALUE = {PAWN: 1, LANCE: 3, KNIGHT: 4, SILVER: 5, GOLD: 6, BISHOP: 8, ROOK: 10, KING: 0,
         8: 7, 9: 6, 10: 6, 11: 6, 13: 10, 14: 12}
IMPASSE_POINTS = {k: (5 if k in (BISHOP, ROOK, 13, 14) else 0 if k == KING else 1)
                  for k in VALUE}
# plane of each kind, the mover's (the opponent's is 14 more)
PLANE = {PAWN: 0, LANCE: 1, KNIGHT: 2, SILVER: 3, GOLD: 4, BISHOP: 5, ROOK: 6, KING: 7,
         8: 8, 9: 9, 10: 10, 11: 11, 13: 12, 14: 13}

NOT_OVER, CHECKMATE, REPETITION, PERPETUAL_CHECK, IMPASSE, MAX_MOVES = range(6)


def _ray(sq: int, d: int) -> tuple[int, ...]:
    r, c = divmod(sq, 9)
    dr, dc = DIRS[d]
    out = []
    while True:
        r, c = r + dr, c + dc
        if not (0 <= r < 9 and 0 <= c < 9):
            return tuple(out)
        out.append(r * 9 + c)


RAYS = [[_ray(s, d) for d in range(8)] for s in range(81)]
# the squares a knight of the mover jumps to from each square: (left, right)
JUMPS = [tuple((s // 9 - 2) * 9 + s % 9 + dc if s // 9 >= 2 and 0 <= s % 9 + dc < 9 else -1
               for dc in (-1, 1)) for s in range(81)]
ALIGNED = [[any(t in RAYS[s][d] for d in range(8)) for t in range(81)] for s in range(81)]


def startpos() -> list[int]:
    b = [EMPTY] * 81
    back = [LANCE, KNIGHT, SILVER, GOLD, KING, GOLD, SILVER, KNIGHT, LANCE]
    for c, k in enumerate(back):
        b[c], b[72 + c] = k + 16, k
    b[9 + 1], b[9 + 7] = ROOK + 16, BISHOP + 16
    b[63 + 1], b[63 + 7] = BISHOP, ROOK
    for c in range(9):
        b[18 + c], b[54 + c] = PAWN + 16, PAWN
    return b


def turned(board: list[int]) -> list[int]:
    """The board turned 180 degrees with the colours swapped."""
    return [c if c < 0 else c ^ 16 for c in reversed(board)]


def attacked(pb: list[int], x: int) -> bool:
    """Whether the opponent (cells >= 16, playing south) attacks square x."""
    for d in range(8):
        for k, y in enumerate(RAYS[x][d]):
            c = pb[y]
            if c < 0:
                continue
            # a piece at y reaches x in the opponent's direction opposite to
            # d, which is d in the mover's terms
            if c >= 16 and REACH[c - 16][d] > k:
                return True
            break
    r, col = divmod(x, 9)
    if r >= 2:
        for dc in (-1, 1):
            if 0 <= col + dc < 9 and pb[x - 18 + dc] == KNIGHT + 16:
                return True
    return False


def _king(pb: list[int], colour: int) -> int:
    try:
        return pb.index(KING + 16 * colour)
    except ValueError:
        return -1


def in_check(pb: list[int]) -> bool:
    k = _king(pb, 0)
    return k >= 0 and attacked(pb, k)


def legal_actions(pb: list[int], hand: list[int], opp_hand: list[int], first: bool = False):
    """The mover's legal actions, ascending, on the perspective board `pb`
    (the mover's cells 0-15); with `first`, stop at the first one found."""
    out = []
    ks = _king(pb, 0)
    check = ks >= 0 and attacked(pb, ks)

    def safe(frm: int, to: int, cell: int) -> bool:
        b = list(pb)
        if frm >= 0:
            b[frm] = EMPTY
        b[to] = cell
        k = to if cell == KING else ks
        return k < 0 or not attacked(b, k)

    for s in range(81):
        c = pb[s]
        if c < 0 or c >= 16:
            continue
        test = check or c == KING or (ks >= 0 and ALIGNED[ks][s])
        fr = s // 9
        for d in range(8):
            reach = REACH[c][d]
            if not reach:
                continue
            for dist, t in enumerate(RAYS[s][d][:reach], 1):
                tc = pb[t]
                if 0 <= tc < 16:
                    break
                if not test or safe(s, t, c):
                    tr = t // 9
                    must = (c in (PAWN, LANCE) and tr == 0) or (c == KNIGHT and tr <= 1)
                    a = s * SLOTS + d * 8 + dist - 1
                    if not must:
                        out.append(a)
                    if c in CAN_PROMOTE and (fr <= 2 or tr <= 2):
                        out.append(a + 64)
                    if first and out:
                        return out
                if tc >= 16:
                    break
        if c == KNIGHT:
            for lr, t in enumerate(JUMPS[s]):
                if t < 0 or 0 <= pb[t] < 16:
                    continue
                if test and not safe(s, t, c):
                    continue
                tr = t // 9
                a = s * SLOTS + 128 + 2 * lr
                if tr > 1:
                    out.append(a)
                if fr <= 2 or tr <= 2:
                    out.append(a + 1)
                if first and out:
                    return out
    pawn_files = {s % 9 for s in range(81) if pb[s] == PAWN}
    for t in range(81):
        if pb[t] != EMPTY:
            continue
        tr = t // 9
        for p in range(7):
            if hand[p] <= 0:
                continue
            if (p in (PAWN, LANCE) and tr == 0) or (p == KNIGHT and tr <= 1):
                continue
            if p == PAWN and t % 9 in pawn_files:
                continue
            if check and not safe(-1, t, p):
                continue
            if p == PAWN and pb[t - 9] == KING + 16 and _mates(pb, t, hand, opp_hand):
                continue
            out.append(t * SLOTS + 132 + p)
            if first:
                return out
    out.sort()
    return out


def _mates(pb: list[int], t: int, hand: list[int], opp_hand: list[int]) -> bool:
    """Whether a pawn dropped on t (checking the king) leaves the opponent
    without a legal move."""
    b = list(pb)
    b[t] = PAWN
    h = list(hand)
    h[PAWN] -= 1
    return not legal_actions(turned(b), list(opp_hand), h, first=True)


def decode(action: int):
    """(from, to, promote, drop piece or -1) in the mover's perspective."""
    sq, slot = divmod(int(action), SLOTS)
    if slot >= 132:
        return -1, sq, False, slot - 132
    if slot >= 128:
        k = slot - 128
        return sq, sq - 18 + (-1 if k // 2 == 0 else 1), bool(k % 2), -1
    promote = slot >= 64
    d, dist = divmod(slot % 64, 8)
    dr, dc = DIRS[d]
    return sq, sq + (dist + 1) * (dr * 9 + dc), promote, -1


class Game:
    """One env's game in absolute terms, with its positions so far."""

    def __init__(self, max_ply: int):
        self.max_ply = max_ply
        self.reset()

    def reset(self):
        self.board = startpos()
        self.hands = [[0] * 7, [0] * 7]
        self.stm, self.ply = 0, 0
        self.seen: dict = {}          # position -> [earlier occurrences, all in check]
        self.check = False
        self.legal = self._legal()

    def key(self):
        return (tuple(self.board), tuple(self.hands[0]), tuple(self.hands[1]), self.stm)

    def perspective(self) -> list[int]:
        return list(self.board) if self.stm == 0 else turned(self.board)

    def _legal(self) -> list[int]:
        pb = self.perspective()
        self.check = in_check(pb)
        return legal_actions(pb, self.hands[self.stm], self.hands[1 - self.stm])

    def planes(self) -> np.ndarray:
        x = np.zeros((PLANES, 81), dtype=np.float32)
        for s, c in enumerate(self.perspective()):
            if c >= 0:
                x[PLANE[c & 15] + 14 * (c >> 4), s] = 1.0
        own, opp = self.hands[self.stm], self.hands[1 - self.stm]
        x[28:35] = (np.array(own, dtype=np.float32) / HAND_MAX)[:, None]
        x[35:42] = (np.array(opp, dtype=np.float32) / HAND_MAX)[:, None]
        x[42] = 1.0 if self.stm == 0 else 0.0
        x[43] = min(np.float32(self.ply) * (np.float32(1.0) / np.float32(self.max_ply)),
                    np.float32(1.0))
        earlier = self.seen.get(self.key(), [0])[0]
        if earlier:
            x[44 + min(earlier, 4) - 1] = 1.0
        x[48] = 1.0 if self.check else 0.0
        return x

    def material(self, side: int) -> int:
        m = 0
        for c in self.board:
            if c >= 0:
                m += VALUE[c & 15] * (1 if c >> 4 == side else -1)
        for p in range(7):
            m += VALUE[p] * (self.hands[side][p] - self.hands[1 - side][p])
        return m

    def _impasse(self):
        """(declared, winner or -1)."""
        kings = [self.board.index(KING + 16 * s) // 9 for s in (0, 1)]
        if not (kings[0] <= 2 and kings[1] >= 6):
            return False, -1
        zone = [sum(1 for s, c in enumerate(self.board) if c >= 0 and c >> 4 == side
                    and (s // 9 <= 2 if side == 0 else s // 9 >= 6)) for side in (0, 1)]
        if min(zone) < 10:
            return False, -1
        pts = [sum(IMPASSE_POINTS[c & 15] for c in self.board if c >= 0 and c >> 4 == side)
               + sum(n * (5 if p in (BISHOP, ROOK) else 1)
                     for p, n in enumerate(self.hands[side])) for side in (0, 1)]
        if pts[0] < 24 and pts[1] < 24:
            return False, -1
        return True, (-1 if min(pts) >= 24 else 0 if pts[0] >= 24 else 1)

    def step(self, action: int) -> dict:
        """Play `action` (which must be legal); the transition's outcome."""
        if int(action) not in self.legal:
            raise ValueError(f"action {int(action)} is not legal here")
        mover = self.stm
        entry = self.seen.setdefault(self.key(), [0, True])
        entry[0] += 1
        entry[1] = entry[1] and self.check
        frm, to, promote, drop = decode(action)
        if mover == 1:
            frm, to = (80 - frm if frm >= 0 else -1), 80 - to
        if drop >= 0:
            self.hands[mover][drop] -= 1
            self.board[to] = drop + 16 * mover
        else:
            cap = self.board[to]
            if cap >= 0:
                k = cap & 15
                self.hands[mover][k - 8 if k >= 8 else k] += 1
            cell = self.board[frm]
            self.board[frm] = EMPTY
            self.board[to] = cell + 8 if promote else cell
        self.stm, self.ply = 1 - mover, self.ply + 1
        self.legal = self._legal()
        earlier, all_check = self.seen.get(self.key(), [0, True])
        reason, winner = NOT_OVER, -1
        if not self.legal:
            reason, winner = CHECKMATE, mover
        declared, w = self._impasse()
        if declared:
            reason, winner = IMPASSE, w
        if earlier + 1 >= 4:
            reason = PERPETUAL_CHECK if all_check else REPETITION
            winner = self.stm if all_check else -1
        if self.ply >= self.max_ply:
            reason, winner = MAX_MOVES, -1
        out = {"reward": 0.0 if winner < 0 else (1.0 if winner == mover else -1.0),
               "terminated": reason not in (NOT_OVER, MAX_MOVES),
               "truncated": reason == MAX_MOVES, "material": self.material(mover),
               "terminal_obs": self.planes()}
        if reason != NOT_OVER:
            self.reset()
        out["obs"], out["legal"] = self.planes(), self.legal
        return out


def mask_of(actions: list[int]) -> np.ndarray:
    m = np.zeros(ACTIONS, dtype=bool)
    m[actions] = True
    return m

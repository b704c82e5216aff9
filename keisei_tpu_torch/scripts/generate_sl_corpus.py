"""Generate a CSA V2.2 corpus from batched engine games on the port's engine
(counterpart of scripts/generate_sl_corpus.py).

The repo has no outside game records, so the SL pipeline trains on games
the engine plays itself: N envs of the VecEnv host shim (spatial actions)
under a capture-greedy softmax policy (the value of the piece on each
action's destination, a promotion bonus, a drop penalty, plus Gumbel noise
from `np.random.default_rng(seed)`), so that the corpus has learnable
structure. The same policy, output and terminator mapping as the JAX
package's script:

    checkmate / any win by the last mover  -> %TSUMI
    perpetual check (last mover forfeits)  -> %ILLEGAL_MOVE
    repetition draw                        -> %SENNICHITE
    impasse draw                           -> %JISHOGI
    max-ply truncation                     -> %CHUDAN

Moves are written through a host-side CSA board mirror, so piece names
(TO/NY/... after promotion) are exact by construction.

    python -m keisei_tpu_torch.scripts.generate_sl_corpus --games 4000 --out DIR
        [--envs 256] [--max-ply 320] [--temp 1.0] [--seed 0] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from ..engine import tables as T
from ..engine import types as TY
from ..env.spectator_data import move_usi
from ..env.vec_env import VecEnv

USI_TO_CSA = {"P": "FU", "L": "KY", "N": "KE", "S": "GI", "G": "KI",
              "B": "KA", "R": "HI"}
PROMOTE = {"FU": "TO", "KY": "NY", "KE": "NK", "GI": "NG",
           "KA": "UM", "HI": "RY"}
RANKS = "abcdefghi"

# centipawn-ish kind values, indexed by engine kind code (engine/types.py)
KIND_VALUE = np.zeros(16, np.float32)
KIND_VALUE[:8] = [1, 3, 3.5, 5, 6, 8, 10, 0]          # P L N S G B R K
KIND_VALUE[8:12] = [7, 6, 6, 6]                        # +P +L +N +S
KIND_VALUE[13], KIND_VALUE[14] = 12, 13                # +B +R


def initial_csa_board() -> dict[tuple[int, int], str]:
    board: dict[tuple[int, int], str] = {}
    back = ["KY", "KE", "GI", "KI", "OU", "KI", "GI", "KE", "KY"]
    for i, name in enumerate(back):
        board[(9 - i, 1)] = name
        board[(9 - i, 9)] = name
    board[(8, 2)], board[(2, 2)] = "HI", "KA"
    board[(8, 8)], board[(2, 8)] = "KA", "HI"
    for col in range(1, 10):
        board[(col, 3)] = "FU"
        board[(col, 7)] = "FU"
    return board


def usi_to_csa(usi: str, board: dict[tuple[int, int], str], black: bool) -> str:
    """Convert one USI move to a CSA move line, updating the board mirror."""
    sign = "+" if black else "-"
    if usi[1] == "*":
        name = USI_TO_CSA[usi[0]]
        tc, tr = int(usi[2]), RANKS.index(usi[3]) + 1
        board[(tc, tr)] = name
        return f"{sign}00{tc}{tr}{name}"
    fc, fr = int(usi[0]), RANKS.index(usi[1]) + 1
    tc, tr = int(usi[2]), RANKS.index(usi[3]) + 1
    name = board.pop((fc, fr))
    if usi.endswith("+"):
        name = PROMOTE[name]
    board[(tc, tr)] = name
    return f"{sign}{fc}{fr}{tc}{tr}{name}"


def build_action_tables():
    """Perspective-space dest square / promo flag / drop flag per spatial
    action (the spatial action space is perspective-relative, so these do
    not depend on the side to move)."""
    A = TY.ACTION_SPACE
    dest = np.full(A, 0, np.int32)
    valid = np.zeros(A, bool)
    promo = np.zeros(A, np.float32)
    is_drop = np.zeros(A, np.float32)
    for sq in range(81):
        base = sq * 139
        for slot in range(139):
            a = base + slot
            if slot >= 132:
                dest[a], valid[a], is_drop[a] = sq, True, 1.0
            elif slot >= 128:
                k = slot - 128
                d = int(T.KNIGHT_TO[0][sq, k // 2])
                if d >= 0:
                    dest[a], valid[a] = d, True
                promo[a] = float(k % 2)
            else:
                p = slot >= 64
                dslot = slot - 64 if p else slot
                dirn, dist = divmod(dslot, 8)
                d = int(T.RAY[dirn, sq, dist])
                if d >= 0:
                    dest[a], valid[a] = d, True
                promo[a] = float(p)
    return dest, valid, promo, is_drop


def generate_corpus(out_dir: str, *, games: int = 4000, envs: int = 256, max_ply: int = 320,
                    temp: float = 1.0, games_per_file: int = 100, seed: int = 0,
                    device: str = "cuda", game_log: list | None = None) -> dict:
    """Play at least `games` games on `device` and write them as CSA files
    (`gen_NNNN.csa`, `games_per_file` each) plus `corpus_meta.json`;
    returns the stats. `game_log`, when given, receives one (terminator,
    termination reason, reward, plies) per game in file order."""
    dest, valid, promo, is_drop = build_action_tables()

    # opponent piece value per observation channel 14..27
    val_ch = np.zeros(14, np.float32)
    for kind in range(TY.NUM_KINDS):
        ch = int(T.OBS_CHANNEL[kind + 16])
        if ch >= 0:
            val_ch[ch - 14] = KIND_VALUE[kind]

    env = VecEnv(num_envs=envs, max_ply=max_ply, observation_mode="katago",
                 action_mode="spatial", device=device)
    rng = np.random.default_rng(seed)
    N = envs

    os.makedirs(out_dir, exist_ok=True)
    for stale in os.listdir(out_dir):
        if stale.endswith(".csa"):
            os.unlink(os.path.join(out_dir, stale))

    reset = env.reset()
    obs, masks = reset.observations, reset.legal_masks

    moves: list[list[str]] = [[] for _ in range(N)]
    boards = [initial_csa_board() for _ in range(N)]

    finished: list[str] = []
    games_done = 0
    files_written = 0
    plies_total = 0
    term_hist: dict[str, int] = {}
    t0 = time.perf_counter()

    def flush_file() -> None:
        nonlocal files_written, finished
        path = os.path.join(out_dir, f"gen_{files_written:04d}.csa")
        with open(path, "w") as f:
            f.write("\n/\n".join(finished) + "\n")
        files_written += 1
        finished = []

    while games_done < games:
        # capture value at each action's destination, from the opponent
        # piece planes of the (perspective-space) observation
        cap = np.tensordot(obs[:, 14:28].reshape(N, 14, 81), val_ch,
                           axes=([1], [0]))          # (N, 81)
        score = 4.0 * cap[:, dest] * valid + 1.5 * promo - 0.5 * is_drop
        score += temp * rng.gumbel(size=score.shape).astype(np.float32)
        np.copyto(score, -np.inf, where=~masks)
        actions = score.argmax(axis=1)

        pre_ply = [len(m) for m in moves]
        out = env.step(actions)

        for i in range(N):
            usi = move_usi(int(actions[i]), pre_ply[i] % 2)
            moves[i].append(usi_to_csa(usi, boards[i], pre_ply[i] % 2 == 0))

        done = out.terminated | out.truncated
        for i in np.nonzero(done)[0]:
            reward = float(out.rewards[i])
            if out.truncated[i] and not out.terminated[i]:
                term = "%CHUDAN"
            elif reward > 0:
                term = "%TSUMI"
            elif reward < 0:
                term = "%ILLEGAL_MOVE"
            elif out.step_metadata.termination_reason[i] == TY.IMPASSE:
                term = "%JISHOGI"
            else:
                term = "%SENNICHITE"
            term_hist[term] = term_hist.get(term, 0) + 1
            if game_log is not None:
                game_log.append((term, int(out.step_metadata.termination_reason[i]),
                                 reward, len(moves[i])))
            rb, rw = rng.integers(1800, 3000, size=2)
            lines = [
                "V2.2",
                f"N+gen_black_{games_done}",
                f"N-gen_white_{games_done}",
                f"'black_rate:gen_black_{games_done}:{rb}",
                f"'white_rate:gen_white_{games_done}:{rw}",
                "PI", "+",
                *moves[i],
            ]
            if term == "%ILLEGAL_MOVE":
                lines.append("'perpetual check: the repetition-completing "
                             "check is forbidden; last mover forfeits")
            lines.append(term)
            finished.append("\n".join(lines))
            plies_total += len(moves[i])
            games_done += 1
            moves[i] = []
            boards[i] = initial_csa_board()
            if len(finished) >= games_per_file:
                flush_file()

        obs, masks = out.observations, out.legal_masks

    if finished:
        flush_file()
    dt = time.perf_counter() - t0

    stats = {
        "games": games_done,
        "files": files_written,
        "plies": plies_total,
        "mean_ply": round(plies_total / max(games_done, 1), 1),
        "terminations": term_hist,
        "wall_s": round(dt, 1),
        "games_per_s": round(games_done / dt, 2),
        "plies_per_s": round(plies_total / dt, 1),
        "envs": N,
        "temp": temp,
    }
    with open(os.path.join(out_dir, "corpus_meta.json"), "w") as f:
        json.dump(stats, f, indent=1)
    return stats


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--games", type=int, default=4000)
    ap.add_argument("--envs", type=int, default=256)
    ap.add_argument("--max-ply", type=int, default=320)
    ap.add_argument("--temp", type=float, default=1.0,
                    help="Gumbel temperature on the capture-greedy scores")
    ap.add_argument("--games-per-file", type=int, default=100)
    ap.add_argument("--out", required=True)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda, cuda:N or cpu")
    args = ap.parse_args(argv)
    stats = generate_corpus(args.out, games=args.games, envs=args.envs, max_ply=args.max_ply,
                            temp=args.temp, games_per_file=args.games_per_file,
                            seed=args.seed, device=args.device)
    print(json.dumps(stats, indent=1))


if __name__ == "__main__":
    main()

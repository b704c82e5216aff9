"""The dashboard feed end to end, with its checks: SpectatorEnv on the
device against SpectatorEnv on the CPU, an exhibition game of two
random-weight entries at the width of configs/katago-b40c256.toml through
`ShowcaseRunner.run`, a demonstrator game, and the dashboard server over
the database they wrote.

    python -m keisei_tpu_torch.scripts.showcase_smoke [--device cuda] [--blocks N]
        [--max-ply 512] [--spectator-plies 256] [--demo-max-ply 64]

The cuts are printed. The checks (each raises): at every ply of a seeded
random legal game and on an already decided SFEN, the device's env and
the CPU's give equal dicts, SFEN, legal actions and observations; the
exhibition game ends with a result, its showcase_moves rows read back one
per ply with finite value estimates, and the models' parameters lie on the
device; the demonstrator's game leaves demo rows in game_snapshots; the
server's init message and a showcase message validate under
`protocol_spec.validate_message`, and a queue command sent over the
WebSocket lands in showcase_queue. Per ply of the exhibition it prints
the milliseconds of the forward, the spectator step and the DB writes.
chip_smoke.py phase 11 calls `run_feed`.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import math
import os
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from .. import db
from ..db import showcase as sc
from ..env.spectator import SpectatorEnv
from ..league.store import OpponentStore, Role
from ..models.registry import build_model
from ..server.app import DashboardServer
from ..server.protocol_spec import validate_message
from ..server.ws_protocol import client_connect
from ..showcase import runner as runner_mod
from ..showcase.demonstrator import Demonstrator
from .sl_smoke import model_spec

# White to move and mated (black gold on 5b, guarded by the pawn on 5c)
MATED_SFEN = "4k4/4G4/4P4/9/9/9/9/9/4K4 w - 1"
PHASE_BUDGET_S = 60.0


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _same(a: SpectatorEnv, b: SpectatorEnv) -> bool:
    return (a.to_dict() == b.to_dict() and a.to_sfen() == b.to_sfen()
            and a.legal_actions() == b.legal_actions()
            and a.get_observation().tobytes() == b.get_observation().tobytes())


def check_spectator(device: torch.device, plies: int, label: str) -> dict:
    """A seeded random legal game of at most `plies` plies (its max_ply)
    on `device` and on the CPU, held equal at every ply, then a decided
    SFEN; returns the device's milliseconds a step."""
    rng = np.random.default_rng(0)
    dev = SpectatorEnv(plies, "spatial", device=device)
    cpu = SpectatorEnv(plies, "spatial", device="cpu")
    step_s = []
    while True:
        if not _same(dev, cpu):
            raise AssertionError(f"{label}: the {device} env and the CPU's differ at ply "
                                 f"{cpu.ply}")
        if cpu.is_over():
            break
        a = int(rng.choice(cpu.legal_actions()))
        t0 = time.monotonic()
        d = dev.step(a)
        step_s.append(time.monotonic() - t0)
        if d != cpu.step(a):
            raise AssertionError(f"{label}: step {a} at ply {cpu.ply} differs")
    mated = [SpectatorEnv.from_sfen(MATED_SFEN, plies, "spatial", device=x)
             for x in (device, "cpu")]
    if not _same(*mated) or mated[0].to_dict()["result"] != "checkmate":
        raise AssertionError(f"{label}: the decided SFEN gives {mated[0].to_dict()['result']}")
    r = {"plies": cpu.ply, "result": cpu.to_dict()["result"],
         "step_ms": 1e3 * float(np.mean(step_s[1:] or step_s))}
    print(f"{label} spectator {device} == cpu plies={r['plies']} result={r['result']} "
          f"step_ms={r['step_ms']:.3f} decided_sfen=checkmate")
    return r


def seed_store(device: torch.device, tmp: str, params: dict) -> OpponentStore:
    """Two random-weight se_resnet entries (float32 state dicts)."""
    store = OpponentStore(os.path.join(tmp, "obs.db"), os.path.join(tmp, "league"),
                          device=device)
    for seed in (0, 1):
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            sd = build_model("se_resnet", params)[0].state_dict()
        store.add_entry(sd, architecture="se_resnet", model_params=params,
                        created_epoch=0, role=(Role.FRONTIER_STATIC, Role.DYNAMIC)[seed])
    return store


class _Clock:
    """Host seconds spent in wrapped callables, per name."""

    def __init__(self):
        self.s: dict[str, list[float]] = {}

    def wrap(self, name: str, fn, device: torch.device):
        def timed(*a, **kw):
            t0 = time.monotonic()
            out = fn(*a, **kw)
            _sync(device)
            self.s.setdefault(name, []).append(time.monotonic() - t0)
            return out
        return timed


def play_exhibition(device: torch.device, store: OpponentStore, max_ply: int,
                    step_ms: float, label: str) -> dict:
    """One queued match through ShowcaseRunner.run on a thread, the move
    delays zeroed; max_ply cut to 256 (and the cut printed) where the
    forward and step times measured first put the game past
    PHASE_BUDGET_S."""
    db_path = store.db_path
    runner = runner_mod.ShowcaseRunner(db_path, store.league_dir, max_ply=max_ply,
                                       auto_showcase=False, store=store)
    runner._rng = np.random.default_rng(0)
    model = runner.cache.get(1)
    params_on = {str(p.device) for p in model.parameters()}
    if params_on != {str(store.device)}:
        raise AssertionError(f"{label}: model parameters on {params_on}, not {store.device}")
    env = SpectatorEnv(16, "spatial", device=device)
    runner_mod.policy_and_value(model, env)  # cuDNN's plans for B=1
    _sync(device)
    t0 = time.monotonic()
    for _ in range(5):
        runner_mod.policy_and_value(model, env)
    fwd_ms = 1e3 * (time.monotonic() - t0) / 5
    estimate_s = max_ply * (fwd_ms + step_ms) / 1e3
    if estimate_s > PHASE_BUDGET_S and max_ply > 256:
        print(f"{label} cut showcase max_ply = 256 (512 plies at {fwd_ms:.1f} + "
              f"{step_ms:.1f} ms would take {estimate_s:.0f} s)")
        runner.max_ply = max_ply = 256

    clock = _Clock()
    saved = (runner_mod.SPEED_DELAYS, runner_mod.policy_and_value, runner_mod.SpectatorEnv,
             sc.write_showcase_move, sc.write_heartbeat)

    class TimedEnv(SpectatorEnv):
        step = clock.wrap("step", SpectatorEnv.step, device)

    runner_mod.SPEED_DELAYS = {"slow": 0, "normal": 0, "fast": 0}
    runner_mod.policy_and_value = clock.wrap("forward", runner_mod.policy_and_value, device)
    runner_mod.SpectatorEnv = TimedEnv
    sc.write_showcase_move = clock.wrap("db", sc.write_showcase_move, device)
    sc.write_heartbeat = clock.wrap("db", sc.write_heartbeat, device)
    qid = sc.queue_match(db_path, "1", "2", "fast")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    thread = threading.Thread(target=runner.run, daemon=True, name="showcase")
    try:
        t0 = time.monotonic()
        thread.start()
        deadline = t0 + 10 * PHASE_BUDGET_S
        while sc.get_queue_status(db_path, qid) != "done":
            if time.monotonic() > deadline or not thread.is_alive():
                raise AssertionError(f"{label}: queue entry {qid} is "
                                     f"{sc.get_queue_status(db_path, qid)!r}")
            time.sleep(0.05)
        wall = time.monotonic() - t0
    finally:
        runner.request_stop()
        thread.join(timeout=30)
        (runner_mod.SPEED_DELAYS, runner_mod.policy_and_value, runner_mod.SpectatorEnv,
         sc.write_showcase_move, sc.write_heartbeat) = saved
    if thread.is_alive():
        raise AssertionError(f"{label}: the runner did not stop")

    game = sc.read_showcase_game(db_path, 1)
    moves = sc.read_all_showcase_moves(db_path, 1)
    values = [m["value_estimate"] for m in moves]
    if game["status"] not in ("black_win", "white_win", "draw"):
        raise AssertionError(f"{label}: the game ended {game['status']!r} "
                             f"({game.get('abandon_reason')})")
    if len(moves) != game["total_ply"] or [m["ply"] for m in moves] != \
            list(range(1, game["total_ply"] + 1)):
        raise AssertionError(f"{label}: {len(moves)} move rows for {game['total_ply']} plies")
    if not all(v is not None and math.isfinite(v) for v in values):
        raise AssertionError(f"{label}: value estimates {values}")
    plies = game["total_ply"]
    ms = {k: 1e3 * sum(v) / plies for k, v in clock.s.items()}
    r = {"max_ply": max_ply, "plies": plies, "status": game["status"],
         "result_by": moves[-1]["usi_notation"], "wall_s": wall,
         "ms_per_ply": 1e3 * wall / plies, "forward_ms": ms["forward"],
         "step_ms": ms["step"], "db_ms": ms["db"], "forward_b1_ms": fwd_ms,
         "peak_gb": (torch.cuda.max_memory_allocated(device) / 1e9
                     if device.type == "cuda" else None),
         "value_range": [min(values), max(values)]}
    print(f"{label} showcase plies={plies} status={game['status']} wall_s={wall:.2f} "
          f"ms_per_ply={r['ms_per_ply']:.2f} forward_ms={r['forward_ms']:.2f} "
          f"step_ms={r['step_ms']:.2f} db_ms={r['db_ms']:.2f} peak_gb={r['peak_gb']} "
          f"rows={len(moves)} values_finite=True params_on={sorted(params_on)}")
    return r


def play_demo(store: OpponentStore, max_ply: int, label: str) -> dict:
    demo = Demonstrator(store.db_path, store, demo_slot=0, moves_per_minute=600_000,
                        max_ply=max_ply)
    t0 = time.monotonic()
    demo._play_one(*demo._pick_matchup())
    wall = time.monotonic() - t0
    rows = [r for r in db.read_game_snapshots(store.db_path) if r.get("game_type") == "demo"]
    if not rows or rows[-1]["ply"] < 1 or rows[-1]["game_id"] != 1000:
        raise AssertionError(f"{label}: demo snapshot rows {rows}")
    r = {"plies": rows[-1]["ply"], "result": rows[-1]["result"], "wall_s": wall}
    print(f"{label} demo plies={r['plies']} result={r['result']} wall_s={wall:.2f} "
          f"demo_rows={len(rows)}")
    return r


async def _serve(db_path: str) -> dict:
    server = DashboardServer(db_path)
    srv = await server.start("127.0.0.1", 0)
    port = srv.sockets[0].getsockname()[1]
    try:
        ws = await client_connect("127.0.0.1", port)
        init = json.loads(await ws.recv_text())
        await ws.send_json({"type": "request_showcase_match", "entry_id_1": "1",
                            "entry_id_2": "2", "speed": "normal"})
        seen = []
        while not ({"showcase_match_queued", "showcase_status"} <= {m["type"] for m in seen}):
            seen.append(json.loads(await ws.recv_text()))
        await ws.close()
    finally:
        srv.close()
        await srv.wait_closed()
    return {"init": init, "messages": seen}


def check_server(db_path: str, label: str) -> dict:
    """The dashboard server on an ephemeral localhost port: the init
    message and a showcase message validate, and a queue command sent
    over the WebSocket lands in showcase_queue."""
    before = len(sc.read_queue(db_path))
    r = asyncio.run(asyncio.wait_for(_serve(db_path), 60))
    init = r["init"]
    status = next(m for m in r["messages"] if m["type"] == "showcase_status")
    for m in [init, status, *r["messages"]]:
        v = validate_message(m)
        if v:
            raise AssertionError(f"{label}: {m['type']} violates the protocol: {v}")
    if init["type"] != "init" or not init["league_entries"]:
        raise AssertionError(f"{label}: init {init['type']} with "
                             f"{len(init.get('league_entries', []))} entries")
    queue = sc.read_queue(db_path)
    if len(queue) != before + 1 or (queue[-1]["entry_id_1"], queue[-1]["status"]) != \
            ("1", "pending"):
        raise AssertionError(f"{label}: showcase_queue after the command: {queue}")
    out = {"init_keys": len(init), "messages": [m["type"] for m in r["messages"]],
           "queue_rows": len(queue)}
    print(f"{label} server init_valid=True {out}")
    return out


def run_feed(device: torch.device | str, tmp: str, *, blocks: int | None = None,
             max_ply: int = 512, spectator_plies: int = 256, demo_max_ply: int = 64,
             label: str = "feed") -> dict:
    """The spectator, the showcase, the demonstrator and the server, checked;
    returns what was measured."""
    device = torch.device(device)
    arch, params = model_spec(blocks)
    cuts = [f"spectator max_ply = {spectator_plies}", f"demonstrator max_ply = {demo_max_ply}",
            "showcase SPEED_DELAYS = 0"]
    if blocks is not None:
        cuts.append(f"model.params.num_blocks = {blocks}")
    for cut in cuts:
        print(f"{label} cut {cut}")
    res = {"spectator": check_spectator(device, spectator_plies, label)}
    store = seed_store(device, tmp, params)
    res["showcase"] = play_exhibition(device, store, max_ply, res["spectator"]["step_ms"],
                                      label)
    res["demo"] = play_demo(store, demo_max_ply, label)
    res["server"] = check_server(store.db_path, label)
    return res


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--blocks", type=int, default=None)
    parser.add_argument("--max-ply", type=int, default=512)
    parser.add_argument("--spectator-plies", type=int, default=256)
    parser.add_argument("--demo-max-ply", type=int, default=64)
    args = parser.parse_args(argv)
    with tempfile.TemporaryDirectory() as tmp:
        run_feed(args.device, tmp, blocks=args.blocks, max_ply=args.max_ply,
                 spectator_plies=args.spectator_plies, demo_max_ply=args.demo_max_ply)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Dashboard server: WS push protocol + /healthz + static files, pure stdlib.

Protocol parity with the reference FastAPI server (keisei/server/
app.py:202-658) so the reference WebUI connects unchanged: an `init`
payload, then four concurrent per-connection tasks — 0.2 s cursored
poll-push (metrics_update / game_update / training_status /
league_update), 15 s keepalive pings, a command receiver
(request_showcase_match / change_showcase_speed / cancel_showcase_match),
and a 0.5 s showcase poll (showcase_status / showcase_update with
incremental moves). Host-allowlist middleware covers HTTP and WS.

The web framework is keisei_tpu.server.ws_protocol (no FastAPI/uvicorn in
the TPU serving image); reads run in threads via asyncio.to_thread so
SQLite never blocks the event loop.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import mimetypes
import os
from datetime import UTC, datetime
from pathlib import Path
from typing import Any

from .. import db
from ..db import showcase as sc
from .ws_protocol import WebSocket, WebSocketClosed, handshake_response

logger = logging.getLogger(__name__)

POLL_INTERVAL_S = 0.2
SHOWCASE_POLL_INTERVAL_S = 0.5
LEAGUE_POLL_INTERVAL_S = 5.0
WS_PING_INTERVAL_S = 15.0
POLL_BATCH_SIZE = 100
MAX_METRICS_IN_INIT = 2000
HEARTBEAT_STALE_S = 30
VALID_SPEEDS = frozenset({"slow", "normal", "fast"})
MAX_SHOWCASE_QUEUE_DEPTH = 5
DEFAULT_ALLOWED_HOSTS = frozenset({"127.0.0.1", "localhost", "::1", "testserver"})


def _hostname(host_header: str) -> str:
    host = host_header.strip()
    if host.startswith("["):  # [::1]:port
        return host.split("]")[0][1:]
    return host.rsplit(":", 1)[0] if ":" in host else host


def _system_stats() -> dict[str, Any]:
    stats: dict[str, Any] = {}
    try:
        import psutil

        stats["cpu_percent"] = psutil.cpu_percent(interval=0.1)
        mem = psutil.virtual_memory()
        stats["ram_used_gb"] = round(mem.used / 1024**3, 1)
        stats["ram_total_gb"] = round(mem.total / 1024**3, 1)
    except ImportError:
        stats.update(cpu_percent=None, ram_used_gb=None, ram_total_gb=None)
    stats["gpus"] = []  # TPU util is not host-queryable; keep the key shape
    return stats


def _heartbeat_alive(ts: str | None, stale_s: float = HEARTBEAT_STALE_S) -> bool:
    if not ts:
        return False
    try:
        t = datetime.fromisoformat(ts.replace("Z", "+00:00"))
        return (datetime.now(UTC) - t).total_seconds() < stale_s
    except (ValueError, TypeError):
        return False


class DashboardServer:
    def __init__(self, db_path: str, static_dir: str | None = None,
                 allowed_hosts: frozenset[str] | None = None):
        self.db_path = db_path
        self.static_dir = Path(static_dir) if static_dir else (
            Path(__file__).parent / "static"
        )
        self.allowed_hosts = allowed_hosts or DEFAULT_ALLOWED_HOSTS
        self._server: asyncio.AbstractServer | None = None

    # -- HTTP ------------------------------------------------------------------

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        try:
            request = await asyncio.wait_for(reader.readline(), 10)
            if not request:
                return
            parts = request.decode("latin1").split()
            if len(parts) < 2:
                return
            method, path = parts[0], parts[1]
            headers: dict[str, str] = {}
            while True:
                line = await asyncio.wait_for(reader.readline(), 10)
                if line in (b"\r\n", b"\n", b""):
                    break
                k, _, v = line.decode("latin1").partition(":")
                headers[k.strip().lower()] = v.strip()

            host = _hostname(headers.get("host", ""))
            if host not in self.allowed_hosts:
                logger.warning("rejected request with Host: %s", host)
                await self._respond(writer, 403, {"detail": "Forbidden"})
                return

            if path == "/ws":
                await self._handle_ws(reader, writer, headers)
                return
            if path == "/healthz":
                await self._handle_healthz(writer)
            elif method == "GET":
                await self._handle_static(writer, path)
            else:
                await self._respond(writer, 405, {"detail": "Method Not Allowed"})
        except (TimeoutError, ConnectionError, WebSocketClosed):
            pass
        except Exception:
            logger.exception("request handler error")
        finally:
            try:
                writer.close()
            except RuntimeError:
                pass

    async def _respond(self, writer, status: int, body: dict | bytes,
                       content_type: str = "application/json") -> None:
        reason = {200: "OK", 403: "Forbidden", 404: "Not Found",
                  405: "Method Not Allowed", 503: "Service Unavailable"}
        if isinstance(body, dict):
            body = json.dumps(body).encode()
        writer.write(
            (f"HTTP/1.1 {status} {reason.get(status, '')}\r\n"
             f"Content-Type: {content_type}\r\n"
             f"Content-Length: {len(body)}\r\n"
             "Connection: close\r\n\r\n").encode() + body
        )
        await writer.drain()

    async def _handle_healthz(self, writer) -> None:
        """Reference semantics (app.py:155-167): 200 when the DB is readable;
        training_alive reflects heartbeat age < 30 s."""
        def check():
            try:
                state = db.read_training_state(self.db_path)
            except Exception:
                return None, False
            return state, _heartbeat_alive((state or {}).get("heartbeat_at"))

        state, alive = await asyncio.to_thread(check)
        ok = os.path.exists(self.db_path)
        await self._respond(writer, 200 if ok else 503, {
            "status": "ok" if ok else "no-database",
            "training_alive": alive,
            "training_status": (state or {}).get("status"),
        })

    async def _handle_static(self, writer, path: str) -> None:
        rel = path.lstrip("/").split("?")[0] or "index.html"
        target = (self.static_dir / rel).resolve()
        if (not self.static_dir.is_dir()
                or not target.is_relative_to(self.static_dir.resolve())
                or not target.is_file()):
            await self._respond(writer, 404, {"detail": "Not Found"})
            return
        ctype = mimetypes.guess_type(str(target))[0] or "application/octet-stream"
        await self._respond(writer, 200, target.read_bytes(), content_type=ctype)

    # -- WebSocket --------------------------------------------------------------

    async def _handle_ws(self, reader, writer, headers) -> None:
        resp = handshake_response(headers)
        if resp is None:
            await self._respond(writer, 404, {"detail": "not a websocket"})
            return
        writer.write(resp)
        await writer.drain()
        ws = WebSocket(reader, writer)
        try:
            # ONE showcase snapshot feeds both the init payload and the
            # showcase poller's move cursor: fetching them separately let a
            # move written between the two reads vanish for this client —
            # cursor already past it, init payload without it (ADVICE r1)
            snap = await self._showcase_snapshot()
            async with asyncio.TaskGroup() as tg:
                tg.create_task(self._poll_and_push(ws, snap))
                tg.create_task(self._keepalive(ws))
                tg.create_task(self._receive_commands(ws))
                tg.create_task(self._poll_showcase(ws, snap))
        except* (WebSocketClosed, ConnectionError, asyncio.CancelledError):
            pass
        except* Exception as eg:
            for exc in eg.exceptions:
                logger.warning("websocket task error: %r", exc)
        finally:
            await ws.close()

    async def _showcase_snapshot(self) -> dict:
        """Consistent showcase view shared by init payload and poll cursor."""
        p = self.db_path
        game = await asyncio.to_thread(sc.read_active_showcase_game, p)
        moves = (await asyncio.to_thread(sc.read_all_showcase_moves, p, game["id"])
                 if game else [])
        queue = await asyncio.to_thread(sc.read_queue, p)
        hb = await asyncio.to_thread(sc.read_heartbeat, p)
        return {"game": game, "moves": moves, "queue": queue, "hb": hb}

    async def _poll_and_push(self, ws: WebSocket, snap: dict) -> None:
        p = self.db_path
        # newest window, not rows 1..N: a client (re)connecting to a long
        # run must see current charts immediately instead of crawling from
        # epoch 1 at the poll rate (review r2)
        metrics = await asyncio.to_thread(db.read_metrics_tail, p,
                                          MAX_METRICS_IN_INIT)
        games = await asyncio.to_thread(db.read_game_snapshots, p)
        state = await asyncio.to_thread(db.read_training_state, p)
        league = await asyncio.to_thread(db.read_league_data, p)
        elo_hist = await asyncio.to_thread(db.read_elo_history, p, max_epochs=500)
        t_stats = await asyncio.to_thread(db.read_tournament_stats, p)
        styles = await asyncio.to_thread(db.read_style_profiles, p)
        h2h = await asyncio.to_thread(db.read_head_to_head, p)
        game = snap["game"]
        sc_moves = snap["moves"]
        sc_queue = snap["queue"]
        hb = snap["hb"]

        await ws.send_json({
            "type": "init",
            "games": games,
            "metrics": metrics,
            "training_state": state,
            "league_entries": league["entries"],
            "league_results": league["results"],
            "historical_library": league["historical_library"],
            "gauntlet_results": league["gauntlet_results"],
            "transitions": league["transitions"],
            "elo_history": elo_hist,
            "tournament_stats": t_stats,
            "style_profiles": styles,
            "head_to_head": h2h,
            "showcase": {
                "game": game, "moves": sc_moves, "queue": sc_queue,
                "sidecar_alive": _heartbeat_alive((hb or {}).get("last_heartbeat")),
            },
        })

        last_metrics_id = metrics[-1]["id"] if metrics else 0
        last_game_ts, last_game_id = "", 0
        if games:
            last_game_ts = max(g["updated_at"] for g in games)
            last_game_id = max(g["game_id"] for g in games
                               if g["updated_at"] == last_game_ts)
        last_entry_ids = frozenset(e["id"] for e in league["entries"])
        last_result_id = league["results"][0]["id"] if league["results"] else 0
        last_transition_id = (league["transitions"][0]["id"]
                              if league["transitions"] else 0)
        last_gauntlet_id = max((g["id"] for g in league["gauntlet_results"]),
                               default=0)
        league_elapsed = 0.0
        # lifetime count via SQL, bounded at the init cursor: rows landing
        # after the tail read belong to the poll loop (double-count fix)
        total_episodes = await asyncio.to_thread(
            db.sum_episodes_completed, p, last_metrics_id)

        while True:
            await asyncio.sleep(POLL_INTERVAL_S)
            new_metrics = await asyncio.to_thread(
                db.read_metrics_since, p, last_metrics_id, POLL_BATCH_SIZE
            )
            if new_metrics:
                last_metrics_id = new_metrics[-1]["id"]
                total_episodes += sum(
                    (m.get("episodes_completed") or 0) for m in new_metrics
                )
                await ws.send_json({"type": "metrics_update", "rows": new_metrics})

            changed, last_game_ts, last_game_id = await asyncio.to_thread(
                db.read_game_snapshots_since, p, last_game_ts, last_game_id
            )
            if changed:
                await ws.send_json({"type": "game_update", "snapshots": changed})

            new_state = await asyncio.to_thread(db.read_training_state, p)
            if new_state and (
                state is None
                or new_state.get("current_epoch") != state.get("current_epoch")
                or new_state.get("status") != state.get("status")
                or new_state.get("heartbeat_at") != (state or {}).get("heartbeat_at")
            ):
                state = new_state
                await ws.send_json({
                    "type": "training_status",
                    "status": new_state.get("status"),
                    "phase": new_state.get("phase", ""),
                    "heartbeat_at": new_state.get("heartbeat_at"),
                    "epoch": new_state.get("current_epoch"),
                    "step": new_state.get("current_step"),
                    "episodes": total_episodes,
                    "config_json": new_state.get("config_json"),
                    "display_name": new_state.get("display_name"),
                    "model_arch": new_state.get("model_arch"),
                    "total_epochs": new_state.get("total_epochs"),
                    "system_stats": await asyncio.to_thread(_system_stats),
                    "learner_entry_id": new_state.get("learner_entry_id"),
                })

            league_elapsed += POLL_INTERVAL_S
            if league_elapsed >= LEAGUE_POLL_INTERVAL_S:
                league_elapsed = 0.0
                new_league = await asyncio.to_thread(db.read_league_data, p)
                ids = frozenset(e["id"] for e in new_league["entries"])
                rid = new_league["results"][0]["id"] if new_league["results"] else 0
                tid = (new_league["transitions"][0]["id"]
                       if new_league["transitions"] else 0)
                # gauntlet runs write no league_results/transition rows, so
                # they need their own fingerprint component
                gid_ = max((g["id"] for g in new_league["gauntlet_results"]),
                           default=0)
                if (ids != last_entry_ids or rid != last_result_id
                        or tid != last_transition_id or gid_ != last_gauntlet_id):
                    last_entry_ids, last_result_id, last_transition_id = ids, rid, tid
                    last_gauntlet_id = gid_
                    await ws.send_json({
                        "type": "league_update",
                        "entries": new_league["entries"],
                        "results": new_league["results"],
                        "historical_library": new_league["historical_library"],
                        "gauntlet_results": new_league["gauntlet_results"],
                        "transitions": new_league["transitions"],
                        "elo_history": await asyncio.to_thread(
                            db.read_elo_history, p, max_epochs=500),
                        "tournament_stats": await asyncio.to_thread(
                            db.read_tournament_stats, p),
                        "head_to_head": await asyncio.to_thread(
                            db.read_head_to_head, p),
                        "style_profiles": await asyncio.to_thread(
                            db.read_style_profiles, p),
                    })

    async def _keepalive(self, ws: WebSocket) -> None:
        while True:
            await asyncio.sleep(WS_PING_INTERVAL_S)
            await ws.send_json({"type": "ping"})

    async def _receive_commands(self, ws: WebSocket) -> None:
        while True:
            raw = await ws.recv_text()
            try:
                data = json.loads(raw)
            except (json.JSONDecodeError, ValueError):
                continue
            msg_type = data.get("type", "")
            try:
                if msg_type == "request_showcase_match":
                    await self._cmd_match(ws, data)
                elif msg_type == "change_showcase_speed":
                    await self._cmd_speed(ws, data)
                elif msg_type == "cancel_showcase_match":
                    await self._cmd_cancel(ws, data)
                elif msg_type == "pong":
                    pass
            except Exception:
                logger.exception("command %s failed", msg_type)

    async def _cmd_match(self, ws: WebSocket, data: dict) -> None:
        e1, e2 = str(data.get("entry_id_1", "")), str(data.get("entry_id_2", ""))
        speed = data.get("speed", "normal")
        if speed not in VALID_SPEEDS:
            await ws.send_json({"type": "showcase_error",
                                "error": f"Invalid speed: {speed}"})
            return
        if not e1 or not e2:
            await ws.send_json({"type": "showcase_error",
                                "error": "Both entry_id_1 and entry_id_2 are required"})
            return
        if e1 == e2:
            await ws.send_json({"type": "showcase_error",
                                "error": "Cannot match an entry against itself"})
            return
        queue = await asyncio.to_thread(sc.read_queue, self.db_path)
        if len([q for q in queue if q["status"] == "pending"]) >= MAX_SHOWCASE_QUEUE_DEPTH:
            await ws.send_json({"type": "showcase_error", "error": "Queue is full"})
            return
        await asyncio.to_thread(sc.queue_match, self.db_path, e1, e2, speed)
        await ws.send_json({"type": "showcase_match_queued",
                            "entry_id_1": e1, "entry_id_2": e2, "speed": speed})

    async def _cmd_speed(self, ws: WebSocket, data: dict) -> None:
        qid, speed = data.get("queue_id"), data.get("speed", "")
        if speed not in VALID_SPEEDS:
            await ws.send_json({"type": "showcase_error",
                                "error": f"Invalid speed: {speed}"})
            return
        if qid is None:
            await ws.send_json({"type": "showcase_error",
                                "error": "queue_id is required"})
            return
        if isinstance(qid, bool) or not isinstance(qid, int):
            # strict: int() would silently truncate 3.7 -> 3 (and accept
            # true -> 1), re-targeting a DIFFERENT queue row and replying
            # success for a request that should have been rejected
            await ws.send_json({"type": "showcase_error",
                                "error": "queue_id must be an integer"})
            return
        await asyncio.to_thread(sc.update_queue_speed, self.db_path, qid, speed)
        await ws.send_json({"type": "showcase_speed_changed",
                            "queue_id": qid, "speed": speed})

    async def _cmd_cancel(self, ws: WebSocket, data: dict) -> None:
        qid = data.get("queue_id")
        if qid is None:
            await ws.send_json({"type": "showcase_error",
                                "error": "queue_id is required"})
            return
        if isinstance(qid, bool) or not isinstance(qid, int):
            # strict, with a reply (not a swallowed error): int() coercion
            # would truncate floats / accept booleans and cancel the wrong
            # queue entry while reporting success
            await ws.send_json({"type": "showcase_error",
                                "error": "queue_id must be an integer"})
            return
        await asyncio.to_thread(sc.cancel_match, self.db_path, qid)
        await ws.send_json({"type": "showcase_match_cancelled", "queue_id": qid})

    async def _poll_showcase(self, ws: WebSocket, snap: dict) -> None:
        last_fp: tuple = (None, 0, False)
        # the cursor starts at the exact game/ply the init payload carried
        # (same snapshot): the client already has those moves, and any move
        # written after the snapshot is >= the cursor, so none are skipped
        game0 = snap["game"]
        last_game_id: int | None = game0["id"] if game0 else None
        last_ply = max((m["ply"] for m in snap["moves"]), default=0)
        while True:
            await asyncio.sleep(SHOWCASE_POLL_INTERVAL_S)
            game = await asyncio.to_thread(sc.read_active_showcase_game, self.db_path)
            queue = await asyncio.to_thread(sc.read_queue, self.db_path)
            hb = await asyncio.to_thread(sc.read_heartbeat, self.db_path)
            alive = _heartbeat_alive((hb or {}).get("last_heartbeat"))
            gid = game["id"] if game else None
            if gid != last_game_id:
                if last_game_id is not None:
                    # drain the finished game BEFORE switching cursors: the
                    # runner writes the mating move, sleeps a move-delay,
                    # then flips status — a poll landing after the flip
                    # would otherwise drop the final move(s) and the
                    # completed game row (result never pushed; review r2)
                    done_game = await asyncio.to_thread(
                        sc.read_showcase_game, self.db_path, last_game_id)
                    tail = await asyncio.to_thread(
                        sc.read_showcase_moves_since, self.db_path,
                        last_game_id, last_ply)
                    if done_game and (tail or done_game.get("status")
                                      != "in_progress"):
                        await ws.send_json({"type": "showcase_update",
                                            "game": done_game,
                                            "new_moves": tail})
                last_ply = 0
                last_game_id = gid
            fp = (gid, len(queue), alive)
            if fp != last_fp:
                last_fp = fp
                await ws.send_json({"type": "showcase_status", "queue": queue,
                                    "active_game_id": gid, "sidecar_alive": alive})
            if game:
                moves = await asyncio.to_thread(
                    sc.read_showcase_moves_since, self.db_path, game["id"], last_ply
                )
                if moves:
                    last_ply = max(m["ply"] for m in moves)
                    await ws.send_json({"type": "showcase_update", "game": game,
                                        "new_moves": moves})

    # -- lifecycle ---------------------------------------------------------------

    async def start(self, host: str = "127.0.0.1", port: int = 8765,
                    unix_socket: str | None = None):
        db.init_db(self.db_path)
        if unix_socket:
            if os.path.exists(unix_socket):
                os.unlink(unix_socket)
            self._server = await asyncio.start_unix_server(self._handle, unix_socket)
        else:
            self._server = await asyncio.start_server(self._handle, host, port)
        return self._server

    async def serve_forever(self, host: str = "127.0.0.1", port: int = 8765,
                            unix_socket: str | None = None):
        server = await self.start(host, port, unix_socket)
        logger.info("dashboard serving on %s (db=%s)",
                    unix_socket or f"{host}:{port}", self.db_path)
        async with server:
            await server.serve_forever()


def main(argv=None):
    p = argparse.ArgumentParser(description="keisei-tpu dashboard server")
    p.add_argument("--db", required=True)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8765)
    p.add_argument("--static-dir", default=None)
    p.add_argument("--unix-socket", default=None,
                   help="serve on a unix socket instead of TCP (run.sh parity)")
    p.add_argument("--allow-host", action="append", default=[],
                   help="additional allowed Host header values")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO, force=True)
    server = DashboardServer(
        args.db, args.static_dir,
        allowed_hosts=DEFAULT_ALLOWED_HOSTS | frozenset(args.allow_host)
        | frozenset({args.host}),
    )
    asyncio.run(server.serve_forever(args.host, args.port, args.unix_socket))


if __name__ == "__main__":
    main()

"""The port's dashboard server (keisei_tpu_torch/server/, byte-identical
copies of keisei_tpu/server/) against the JAX package's, both serving one
database that the port wrote: the port's trainer (training state,
metrics, game snapshots), the port's league store (entries) and the
port's showcase runner (a game in progress, its moves, the queue and the
heartbeat).

Each server's own `client_connect` receives the init message, and the two
are equal; a metrics row written after connecting arrives from both as the
same `metrics_update`; the port's `validate_message` finds no fault in any
message either server sent; both serve the same static page."""

import asyncio
import json
import threading
import time
import types

import numpy as np
import pytest
import torch

import keisei_tpu_torch.showcase.runner as runner_mod
from keisei_tpu.server.app import DashboardServer as JaxDashboardServer
from keisei_tpu.server.ws_protocol import client_connect as jax_client_connect
from keisei_tpu_torch import db
from keisei_tpu_torch.db import core as dbcore
from keisei_tpu_torch.db import showcase as sc
from keisei_tpu_torch.league.store import OpponentStore, Role
from keisei_tpu_torch.models.registry import build_model
from keisei_tpu_torch.server.app import DashboardServer
from keisei_tpu_torch.server.protocol_spec import validate_message
from keisei_tpu_torch.server.ws_protocol import client_connect
from keisei_tpu_torch.showcase.runner import ShowcaseRunner
from keisei_tpu_torch.training.config import config_from_dict
from keisei_tpu_torch.training.loop import SelfPlayTrainer

torch.set_num_threads(2)

TINY = {"num_blocks": 1, "channels": 16, "global_pool_channels": 8, "se_reduction": 4,
        "dtype": "float32"}
PAUSE_AT_PLY = 4


@pytest.fixture
def feed(tmp_path, monkeypatch):
    """The port's writers on one DB; the showcase runner is held on a
    thread after PAUSE_AT_PLY moves, its game in progress, until the test
    releases it."""
    db_path = str(tmp_path / "obs.db")
    cfg = config_from_dict({
        "model": {"architecture": "se_resnet", "params": TINY},
        "training": {"num_games": 4, "max_ply": 12, "steps_per_epoch": 4,
                     "checkpoint_dir": str(tmp_path / "ck"),
                     "algorithm_params": {"batch_size": 8, "epochs_per_batch": 1}},
        "display": {"db_path": db_path}})
    SelfPlayTrainer(cfg, device="cpu").run(1)
    store = OpponentStore(db_path, str(tmp_path / "league"), device="cpu")
    for seed in (0, 1):
        torch.manual_seed(seed)
        store.add_entry(build_model("se_resnet", TINY)[0].state_dict(),
                        architecture="se_resnet", model_params=TINY, created_epoch=0,
                        role=Role.DYNAMIC)

    paused, release, plies = threading.Event(), threading.Event(), []

    def sleep(_s):
        plies.append(1)
        if len(plies) == PAUSE_AT_PLY:
            paused.set()
            release.wait(60)

    monkeypatch.setattr(runner_mod, "SPEED_DELAYS", {"slow": 0, "normal": 0, "fast": 0})
    monkeypatch.setattr(runner_mod, "time", types.SimpleNamespace(
        monotonic=time.monotonic, sleep=sleep))
    sc.queue_match(db_path, "1", "2", "fast")
    runner = ShowcaseRunner(db_path, str(tmp_path / "league"), max_ply=12,
                            auto_showcase=False, store=store)
    t = threading.Thread(target=runner.play_match, args=(sc.claim_next_match(db_path),),
                         daemon=True)
    t.start()
    assert paused.wait(60), "the showcase game never reached its pause"
    yield db_path
    release.set()
    runner.request_stop()
    t.join(timeout=30)
    assert not t.is_alive()


async def _session(server, connect, db_path, wrote: asyncio.Event, written: asyncio.Event):
    srv = await server.start("127.0.0.1", 0)
    port = srv.sockets[0].getsockname()[1]
    try:
        r, w = await asyncio.open_connection("127.0.0.1", port)
        w.write(b"GET /index.html HTTP/1.1\r\nHost: 127.0.0.1\r\n\r\n")
        await w.drain()
        page = (await r.read()).split(b"\r\n\r\n", 1)[1]
        w.close()
        ws = await connect("127.0.0.1", port)
        msgs = [json.loads(await ws.recv_text())]
        wrote.set()
        await written.wait()
        while msgs[-1]["type"] != "metrics_update":
            msgs.append(json.loads(await ws.recv_text()))
        await ws.close()
        return page, msgs
    finally:
        srv.close()
        await srv.wait_closed()


def test_both_servers_send_the_same_messages(feed):
    db_path = feed

    async def scenario():
        ready = [asyncio.Event(), asyncio.Event()]
        written = asyncio.Event()
        tasks = [asyncio.create_task(_session(JaxDashboardServer(db_path), jax_client_connect,
                                              db_path, ready[0], written)),
                 asyncio.create_task(_session(DashboardServer(db_path), client_connect,
                                              db_path, ready[1], written))]
        for e in ready:
            await e.wait()
        # written after both clients hold their init message
        await asyncio.to_thread(db.write_metrics, db_path, {
            "epoch": 99, "step": 990, "policy_loss": 0.25, "episodes_completed": 7})
        written.set()
        return await asyncio.gather(*tasks)

    (jax_page, jax_msgs), (page, msgs) = asyncio.run(asyncio.wait_for(scenario(), 60))
    assert page == jax_page and b"<html" in page.lower()
    init, jax_init = msgs[0], jax_msgs[0]
    assert init["type"] == "init"
    assert init == jax_init
    assert init["training_state"]["model_arch"] == "se_resnet"
    assert [m["epoch"] for m in init["metrics"]] == [1]
    assert len(init["games"]) == 4 and len(init["league_entries"]) == 2
    game = init["showcase"]["game"]
    assert game["status"] == "in_progress"
    assert [m["ply"] for m in init["showcase"]["moves"]] == list(range(1, PAUSE_AT_PLY + 1))
    assert init["showcase"]["sidecar_alive"] is True
    update, jax_update = msgs[-1], jax_msgs[-1]
    assert update == jax_update
    assert [r["epoch"] for r in update["rows"]] == [99]
    for m in msgs + jax_msgs:
        assert validate_message(m) == [], m["type"]
    assert np.isfinite([m["value_estimate"] for m in init["showcase"]["moves"]]).all()


COMMANDS = [
    {"type": "request_showcase_match", "entry_id_1": "1", "entry_id_2": "2", "speed": "fast"},
    {"type": "request_showcase_match", "entry_id_1": "1", "entry_id_2": "1"},
    {"type": "request_showcase_match", "entry_id_1": "1", "entry_id_2": "2", "speed": "warp"},
    {"type": "change_showcase_speed", "queue_id": 1, "speed": "slow"},
    {"type": "change_showcase_speed", "queue_id": 1.5, "speed": "slow"},
    {"type": "cancel_showcase_match", "queue_id": True},
    {"type": "cancel_showcase_match", "queue_id": 1},
]


def test_showcase_commands_get_the_same_replies_and_rows(tmp_path):
    """The WS command surface on two fresh DBs, one per server: the same
    replies in order, and the same showcase_queue rows after them (the
    queued match, its speed change and its cancellation)."""

    async def drive(server, connect, db_path):
        db.init_db(db_path)
        srv = await server.start("127.0.0.1", 0)
        port = srv.sockets[0].getsockname()[1]
        try:
            ws = await connect("127.0.0.1", port)
            assert json.loads(await ws.recv_text())["type"] == "init"
            replies = []
            for cmd in COMMANDS:
                await ws.send_json(cmd)
                while True:
                    m = json.loads(await ws.recv_text())
                    if m["type"].startswith("showcase_") and m["type"] not in (
                            "showcase_status", "showcase_update"):
                        replies.append(m)
                        break
            await ws.close()
            return replies
        finally:
            srv.close()
            await srv.wait_closed()

    jdb, pdb = str(tmp_path / "jax.db"), str(tmp_path / "port.db")
    jax_replies = asyncio.run(asyncio.wait_for(
        drive(JaxDashboardServer(jdb), jax_client_connect, jdb), 60))
    replies = asyncio.run(asyncio.wait_for(drive(DashboardServer(pdb), client_connect, pdb), 60))
    assert replies == jax_replies
    assert [r["type"] for r in replies].count("showcase_error") == 4
    def queue(path):
        keep = ("id", "entry_id_1", "entry_id_2", "speed", "status")
        return [{k: r[k] for k in keep}
                for r in dbcore.fetch_all(path, "SELECT * FROM showcase_queue ORDER BY id")]

    rows = queue(pdb)
    assert rows == queue(jdb)
    assert [(r["speed"], r["status"]) for r in rows] == [("slow", "cancelled")]

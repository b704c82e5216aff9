"""The launch environment, the process group and rank 0's broadcast
(counterpart of keisei_tpu/parallel/distributed.py).

The JAX package runs one process per host and one SPMD program over a
global device mesh. The port follows PyTorch's idiom instead: one process
(rank) per card, joined in a `torch.distributed` process group. The host
processes are found the same way:

  KEISEI_COORDINATOR    host:port of process 0 (the rendezvous store)
  KEISEI_NUM_PROCESSES  total host processes
  KEISEI_PROCESS_ID     this host's index
  KEISEI_DISTRIBUTED    "auto": the launcher set torch's own variables
                        (torchrun: RANK, WORLD_SIZE, LOCAL_RANK,
                        LOCAL_WORLD_SIZE, MASTER_ADDR, MASTER_PORT) and each
                        process is one rank

with the JAX package's error cases. `training.loop.main` turns them and
`[distributed] num_devices` into ranks (`rank_layout`). Rank 0 alone writes
the DB, the checkpoints and the league store; the other ranks receive what
only rank 0 can decide (the league cohort) through `broadcast_from_main`.
"""

from __future__ import annotations

import logging
import os
import socket
from dataclasses import dataclass
from datetime import timedelta

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

GROUP_TIMEOUT = timedelta(minutes=10)


@dataclass(frozen=True)
class DistributedContext:
    process_id: int = 0
    num_processes: int = 1
    coordinator: str | None = None
    auto: bool = False

    @property
    def is_main(self) -> bool:
        return self.process_id == 0

    @property
    def is_distributed(self) -> bool:
        return self.num_processes > 1 or self.auto


def get_distributed_context(env: dict | None = None) -> DistributedContext:
    """Parse the launch environment, with the JAX package's rules and errors."""
    env = env if env is not None else os.environ
    if env.get("KEISEI_DISTRIBUTED", "").lower() == "auto":
        return DistributedContext(auto=True)
    coord = env.get("KEISEI_COORDINATOR")
    if not coord:
        return DistributedContext()
    try:
        n = int(env.get("KEISEI_NUM_PROCESSES", "1"))
        pid = int(env.get("KEISEI_PROCESS_ID", "0"))
    except ValueError as e:
        raise ValueError(f"bad distributed env vars: {e}") from e
    if n <= 1:
        # a forgotten KEISEI_NUM_PROCESSES: training alone would let several
        # processes write the checkpoints and the DB at once
        raise ValueError(
            "KEISEI_COORDINATOR is set but KEISEI_NUM_PROCESSES is "
            f"{n} — set it to the total process count (or unset the "
            "coordinator for single-process runs)")
    if not 0 <= pid < n:
        raise ValueError(f"KEISEI_PROCESS_ID {pid} out of range for {n} processes")
    return DistributedContext(process_id=pid, num_processes=n, coordinator=coord)


def torchrun_layout(env: dict | None = None) -> tuple[str, int, int, int, int]:
    """(coordinator, world size, local world size, global rank of this
    host's local rank 0, local rank) from the variables a launcher such as
    torchrun sets for each process under KEISEI_DISTRIBUTED=auto: RANK,
    WORLD_SIZE, MASTER_ADDR, MASTER_PORT, and LOCAL_RANK / LOCAL_WORLD_SIZE
    (0 / WORLD_SIZE when unset, one host). A missing or inconsistent
    variable raises, naming it."""
    env = env if env is not None else os.environ
    missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT") if not env.get(k)]
    if missing:
        raise ValueError(f"KEISEI_DISTRIBUTED=auto takes the ranks from the launcher's "
                         f"variables; {', '.join(missing)} not set")
    try:
        rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
        local_rank = int(env.get("LOCAL_RANK", "0"))
        local_world = int(env.get("LOCAL_WORLD_SIZE", env["WORLD_SIZE"]))
    except ValueError as e:
        raise ValueError(f"bad launcher env vars: {e}") from e
    if not 0 <= rank < world:
        raise ValueError(f"RANK {rank} out of range for WORLD_SIZE {world}")
    if not 0 <= local_rank < local_world <= world or local_rank > rank:
        raise ValueError(f"LOCAL_RANK {local_rank} / LOCAL_WORLD_SIZE {local_world} do not fit "
                         f"RANK {rank} of WORLD_SIZE {world}")
    return (f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}", world, local_world,
            rank - local_rank, local_rank)


def process_seed(base_seed: int, rank: int | DistributedContext) -> int:
    """A rank's own host-side seed: base + rank (the JAX package's
    process_seed, base + process id, when given a DistributedContext)."""
    if isinstance(rank, DistributedContext):
        rank = rank.process_id
    return base_seed + rank


def rank_layout(num_devices: int, ctx: DistributedContext, platform: str) -> tuple[int, int]:
    """(world size, ranks per host process) for `[distributed] num_devices`:
    0 or 1 one rank; -1 every visible card on every host (on the CPU, one
    rank per host process); N N ranks, split evenly over the host
    processes. Hosts are assumed alike. A request that cannot be met raises."""
    hosts = ctx.num_processes
    if num_devices in (0, 1):
        if hosts > 1:
            raise ValueError(f"{hosts} host processes were launched but distributed.num_devices "
                             f"= {num_devices} asks for one rank")
        return 1, 1
    if num_devices == -1:
        local = torch.cuda.device_count() if platform == "cuda" else 1
        if local == 0:
            raise ValueError("distributed.num_devices = -1 counts the visible cards, and "
                             "CUDA sees none")
        return local * hosts, local
    if num_devices < -1:
        raise ValueError(f"distributed.num_devices must be -1, 0 or a rank count, "
                         f"got {num_devices}")
    if num_devices % hosts:
        raise ValueError(f"distributed.num_devices = {num_devices} ranks do not split evenly "
                         f"over {hosts} host processes")
    local = num_devices // hosts
    if platform == "cuda" and local > torch.cuda.device_count():
        raise ValueError(f"{local} ranks per host need {local} cards; "
                         f"{torch.cuda.device_count()} are visible")
    return num_devices, local


def free_port() -> int:
    """A free TCP port on localhost, for a single-host rendezvous."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _device_identity(device: torch.device) -> str:
    return f"{socket.gethostname()}/{torch.cuda.get_device_properties(device).uuid}"


def check_distinct_devices(store, rank: int, world_size: int, identity: str) -> None:
    """Raise when another rank has published the same device `identity`
    on `store`: NCCL refuses two ranks on one card, and it should fail
    here, before the group starts, with a message that says so."""
    store.set(f"keisei/device/{rank}", identity)
    for other in range(world_size):
        if other != rank and store.get(f"keisei/device/{other}").decode() == identity:
            raise RuntimeError(
                f"ranks {min(rank, other)} and {max(rank, other)} are both on {identity}: "
                "NCCL needs one card per rank; give each rank its own card, or pass "
                "backend='gloo' to share one")


def setup_distributed(coordinator: str, *, world_size: int, rank: int,
                      device: str | torch.device, backend: str | None = None,
                      timeout: timedelta = GROUP_TIMEOUT) -> None:
    """Join the default process group of `world_size` ranks as `rank`.

    `coordinator` (host:port) is the rendezvous: rank 0 serves a TCPStore
    there. The backend is NCCL where the rank's device is a card and gloo on
    the CPU; `backend=` chooses one explicitly (gloo lets two ranks share a
    card: tests and the one-card smoke run). NCCL with two ranks on one
    card raises, and so does a group that does not come up within
    `timeout`: nothing falls back to another backend or to one rank."""
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized in this process")
    device = torch.device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r} (nccl or gloo)")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"the NCCL backend needs a card, got device {device}")
    host, sep, port = coordinator.rpartition(":")
    if not sep or not host or not port.isdigit():
        raise ValueError(f"coordinator {coordinator!r} is not host:port")
    store = dist.TCPStore(host, int(port), world_size, is_master=rank == 0, timeout=timeout)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
        if backend == "nccl":
            check_distinct_devices(store, rank, world_size, _device_identity(device))
    dist.init_process_group(backend, store=store, rank=rank, world_size=world_size,
                            timeout=timeout)
    logger.info("distributed: rank %d/%d on %s (%s)", rank, world_size, device, backend)


def teardown_distributed() -> None:
    """Leave the default process group, if this process is in one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def broadcast_from_main(tree: dict[str, torch.Tensor], mesh) -> dict[str, torch.Tensor]:
    """Rank 0's tensors on every rank (the league cohort's keys and its
    stacked bf16 weights, which only rank 0, the owner of the opponent
    store, can produce). The other ranks pass buffers of the same keys,
    shapes and dtypes (league_ops.stacked_cohort_template), which receive
    the values and are returned. One rank: `tree` unchanged."""
    if mesh.group is None:
        return tree
    mesh.broadcast_(list(tree.values()))
    return tree

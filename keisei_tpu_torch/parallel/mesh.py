"""The rank layout of data parallelism (counterpart of keisei_tpu/parallel/mesh.py).

The JAX package builds a 1-D device mesh, shards the env batch over its
"data" axis and replicates the state; XLA then makes BatchNorm statistics
and gradients global inside one program. Here each rank is a process on
its own card: `Mesh` says which rank this is, rank r holds global envs
[r N/W, (r+1) N/W) as P("data") lays them out (`shard_env_batch`), the
state starts as rank 0's (`replicate`), and the update sums what XLA's
psums would: BatchNorm moments (`all_reduce_sum`, differentiable) and the
gradients, through one flat bucket per minibatch (`GradientBucket`).

Every collective goes through a Mesh method, which counts it by kind in
`Mesh.collectives`.
"""

from __future__ import annotations

from collections import Counter, defaultdict
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

from ..utils.device import resolve_device


@dataclass(frozen=True)
class Mesh:
    """One rank's view of the data-parallel layout. `group` is None on a
    single rank, which then runs with no collective at all."""

    world_size: int = 1
    rank: int = 0
    local_rank: int = 0
    local_world_size: int = 1
    device: torch.device = torch.device("cpu")
    group: object | None = None
    collectives: Counter = field(default_factory=Counter, compare=False, repr=False)

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    @property
    def single_host(self) -> bool:
        return self.world_size == self.local_world_size

    def env_slice(self, num_envs: int) -> slice:
        """This rank's contiguous share of `num_envs` global envs."""
        if num_envs % self.world_size:
            raise ValueError(f"num_games {num_envs} must divide evenly over "
                             f"{self.world_size} ranks")
        n = num_envs // self.world_size
        return slice(self.rank * n, (self.rank + 1) * n)

    # -- collectives ----------------------------------------------------------------

    def all_reduce_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum `t` over the ranks, in place."""
        self.collectives["all_reduce"] += 1
        dist.all_reduce(t, group=self.group)
        return t

    def all_gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's `t` (equal shapes), concatenated along `dim` in rank order."""
        self.collectives["all_gather"] += 1
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.world_size)]
        dist.all_gather(parts, t, group=self.group)
        return torch.cat(parts, dim=dim)

    def broadcast_(self, tensors: list[torch.Tensor]) -> None:
        """Rank 0's values into `tensors` on every rank, in place: one
        broadcast per dtype of a flat byte buffer on this rank's device
        (tensors elsewhere, such as Adam's step counts on the host, are
        staged through it)."""
        by_dtype = defaultdict(list)
        for t in tensors:
            by_dtype[t.dtype].append(t)
        for group in by_dtype.values():
            flat = torch.cat([t.detach().reshape(-1).to(self.device) for t in group])
            self.collectives["broadcast"] += 1
            dist.broadcast(flat.view(torch.uint8), src=0, group=self.group)
            if self.rank:
                with torch.no_grad():
                    for t, part in zip(group, flat.split([t.numel() for t in group])):
                        t.copy_(part.view_as(t))

    def barrier(self) -> None:
        self.collectives["barrier"] += 1
        dist.barrier(group=self.group)


def make_mesh(num_devices: int = 0, *, device: str | torch.device | None = None,
              local_rank: int | None = None, local_world_size: int | None = None) -> Mesh:
    """The Mesh of this process in the default process group
    (distributed.setup_distributed), or a single rank with no group when
    there is none and `num_devices` asks for at most one card.

    num_devices: -1 takes the group's size, N must equal it; N > 1 with no
    group raises (it would train alone). `device` defaults to
    cuda:<local_rank>; `local_rank` to the rank, `local_world_size` to the
    world size (one host)."""
    if not dist.is_initialized():
        if num_devices > 1:
            raise ValueError(f"num_devices = {num_devices} needs {num_devices} ranks in a "
                             "process group (distributed.setup_distributed); none is running")
        return Mesh(device=resolve_device(device if device is not None else "cuda"))
    world, rank = dist.get_world_size(), dist.get_rank()
    if num_devices not in (-1, world) and not (num_devices == 0 and world == 1):
        raise ValueError(f"num_devices = {num_devices} but the process group has {world} ranks")
    local_rank = rank if local_rank is None else local_rank
    local_world_size = world if local_world_size is None else local_world_size
    device = resolve_device(device if device is not None else f"cuda:{local_rank}")
    return Mesh(world_size=world, rank=rank, local_rank=local_rank,
                local_world_size=local_world_size, device=device, group=dist.group.WORLD)


def shard_env_batch(mesh: Mesh, tree):
    """This rank's rows of a tensor, or of each tensor of a dict, tuple or
    list, whose leading dimension is the global env batch."""
    if isinstance(tree, torch.Tensor):
        return tree[mesh.env_slice(tree.shape[0])]
    if isinstance(tree, dict):
        return {k: shard_env_batch(mesh, v) for k, v in tree.items()}
    return type(tree)(shard_env_batch(mesh, v) for v in tree)


def replicate(mesh: Mesh, module: torch.nn.Module,
              optimizer: torch.optim.Optimizer | None = None) -> None:
    """Rank 0's parameters, buffers and optimizer state on every rank, in
    place. Every rank must hold the same structure (the same model and the
    same optimizer steps taken or not)."""
    if mesh.group is None:
        return
    tensors = [*module.parameters(), *module.buffers()]
    if optimizer is not None:
        for p in module.parameters():
            tensors.extend(v for v in optimizer.state.get(p, {}).values()
                           if isinstance(v, torch.Tensor))
    mesh.broadcast_(tensors)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
        ctx.mesh = mesh
        return mesh.all_reduce_(x.clone())

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        # every rank's loss depends on the sum: its gradient is the sum of theirs
        return ctx.mesh.all_reduce_(grad.clone()), None


def all_reduce_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of `x` over the ranks, differentiable: the backward sums
    the ranks' gradients of the result."""
    return _AllReduceSum.apply(x, mesh)


class GradientBucket:
    """The gradients of `params` and `extra` more values (the minibatch's
    loss terms), summed over the ranks through one flat float32 buffer:
    one all-reduce per minibatch whatever the number of tensors."""

    def __init__(self, mesh: Mesh, params: list[torch.Tensor], extra: int):
        self.mesh, self.params = mesh, params
        self.sizes = [p.numel() for p in params] + [extra]
        self.flat = torch.empty(sum(self.sizes), dtype=torch.float32, device=mesh.device)

    def all_reduce(self, extra: torch.Tensor) -> torch.Tensor:
        """Sum every param's .grad (a missing one counts as zeros) and
        `extra` over the ranks; the grads are overwritten with the sums,
        and the summed `extra` is returned."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        torch.cat([p.grad.reshape(-1) for p in self.params] + [extra.reshape(-1).float()],
                  out=self.flat)
        self.mesh.all_reduce_(self.flat)
        *parts, summed = self.flat.split(self.sizes)
        for p, part in zip(self.params, parts):
            p.grad.copy_(part.view_as(p))
        return summed.clone()

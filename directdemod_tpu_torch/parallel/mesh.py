"""A (time, channel) mesh of shards, and its collectives.

Port of `directdemod_tpu/parallel/mesh.py:19-34`. The parallel axes:
  * `time`    -- one long capture split into blocks, the blocks dealt over
                 the shards, filter tails passed on as halos (`ppermute`);
  * `channel` -- independent `-f` channels of the same capture (ref
                 main.py:147 decodes them one after the other).

A JAX mesh lays named axes over devices and `jax.shard_map` runs one body
per device. Here a `Mesh` is a grid of shards, each naming a
`torch.device`; a shard body is a plain function called once a shard with
its index, and the collectives are plain functions over the list of
per-shard tensors. A device may stand for several shards (one card carries
a 4-shard mesh, as one CPU carries the JAX tests' 8 virtual devices):
shards on one device run one after the other.

After `parallel.distributed.initialize` a mesh made without a device list
spans the processes: each `time` row has an owner rank, a process runs only
the shards it owns, the list of per-shard tensors holds None for the
others, and a collective moves what crosses processes through host memory
(`distributed.exchange`). In one process every shard is local.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve
from . import distributed

# The shards a mesh on the CPU has when no count is given: the JAX
# package's tests run on 8 virtual CPU devices (tests/conftest.py).
CPU_DEVICES = 8


class Mesh:
    """`time` x `channel` shards, time-major: `devices[t][c]` is the device
    of shard (t, c) on its owner, process `ranks[t]`; `rank` is this
    process's."""

    def __init__(self, devices: list, time: int, channel: int,
                 ranks: list | None = None, rank: int = 0):
        self.devices = [[torch.device(devices[t * channel + c])
                         for c in range(channel)] for t in range(time)]
        self.time_ranks = list(ranks) if ranks is not None else [rank] * time
        self.rank = rank

    @property
    def shape(self) -> dict:
        return {"time": len(self.devices), "channel": len(self.devices[0])}

    @property
    def time_devices(self) -> list:
        """The device of each `time` shard (channel 0)."""
        return [row[0] for row in self.devices]

    @property
    def channel_devices(self) -> list:
        """The device of each `channel` shard (time 0)."""
        return list(self.devices[0])

    def rank_of(self, t: int) -> int:
        """The process that owns `time` shard t."""
        return self.time_ranks[t]

    def is_local(self, t: int) -> bool:
        return self.time_ranks[t] == self.rank

    @property
    def local_time(self) -> list:
        """The `time` shards this process owns, in order."""
        return [t for t in range(len(self.devices)) if self.is_local(t)]

    @property
    def spans_processes(self) -> bool:
        return len(set(self.time_ranks)) > 1

    def __repr__(self) -> str:
        ranks = f", ranks {self.time_ranks}" if self.spans_processes else ""
        return f"Mesh({self.shape}, {self.devices}{ranks})"


def visible_devices(device=None) -> list:
    """The devices a mesh takes by default: every CUDA device for
    `device=None` (the port's device rule: it raises without one) or a
    CUDA device, `CPU_DEVICES` times the CPU for `device="cpu"`."""
    dev = resolve(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev] * CPU_DEVICES


def make_mesh(time: int | None = None, channel: int = 1, devices=None,
              device=None) -> Mesh:
    """Mesh over `devices` (a list, which may name a device more than
    once), time-major, in this process. Without a list: after
    `distributed.initialize` the mesh over every process's recorded
    devices, process r owning `time` rows [r T/W, (r+1) T/W); else
    `time * channel` shards on `device` when both are given, else
    `visible_devices(device)`. Raises ValueError when the shape does not
    cover the devices exactly, or `time` is not a multiple of the
    processes."""
    if devices is None and distributed.is_initialized():
        return _process_mesh(time, channel)
    if devices is None:
        if device is not None and time is not None:
            devices = [resolve(device)] * (time * channel)
        else:
            devices = visible_devices(device)
    n = len(devices)
    if time is None:
        time = n // channel
    if time * channel != n:
        raise ValueError(f"{time}x{channel} mesh needs {time * channel} devices, "
                         f"have {n}")
    return Mesh(list(devices), time, channel)


def _process_mesh(time: int | None, channel: int) -> Mesh:
    local = distributed.local_devices()
    world = distributed.world_size()
    n = world * len(local)
    if time is None:
        time = n // channel
    if time * channel != n:
        raise ValueError(f"{time}x{channel} mesh needs {time * channel} devices, "
                         f"have {n}")
    if time % world:
        raise ValueError(f"time axis {time} is not a multiple of the {world} "
                         f"processes")
    rows = time // world
    # every process lays its rows over its own devices alike; a remote row
    # names the devices its owner has in the same places
    devices = [local[(t % rows) * channel + c] for t in range(time)
               for c in range(channel)]
    return Mesh(devices, time, channel, ranks=[t // rows for t in range(time)],
                rank=distributed.rank())


def single_device_mesh(device=None) -> Mesh:
    return Mesh([resolve(device)], 1, 1)


def require_one_process(mesh, what: str) -> None:
    """Raise ValueError when `mesh` spans processes: `what` runs on a mesh
    of one process only."""
    if mesh is not None and mesh.spans_processes:
        raise ValueError(f"{what} does not run on a mesh that spans processes "
                         f"(time shards owned by ranks {sorted(set(mesh.time_ranks))})")


def _owners(xs: list, ranks) -> tuple[list, int]:
    me = distributed.rank() if ranks is not None else 0
    return (list(ranks) if ranks is not None else [me] * len(xs)), me


def ppermute(xs: list, perm: list, devices: list, ranks=None) -> list:
    """`lax.ppermute`: shard d receives xs[s] for each (s, d) in `perm`, as
    a copy on its own device (a copy also when both shards share one, so a
    receiver never aliases its sender); a shard that receives nothing gets
    zeros, as in JAX. `ranks` gives each shard's owner (`Mesh.time_ranks`;
    None: all in this process): xs and the result hold None for another
    process's shards, and a pair across processes goes through the host.
    Every shard's tensor has one shape and dtype, as in JAX."""
    owner, me = _owners(xs, ranks)
    like = next(x for x, r in zip(xs, owner) if r == me)
    out = [torch.zeros_like(like, device=d) if r == me else None
           for d, r in zip(devices, owner)]
    sends, recvs = [], []
    for s, d in perm:
        tag = s * len(xs) + d
        if owner[s] == me and owner[d] == me:
            out[d] = xs[s].to(devices[d], copy=True)
        elif owner[s] == me:
            sends.append((xs[s], owner[d], tag))
        elif owner[d] == me:
            recvs.append((d, (like, owner[s], tag)))
    if sends or recvs:
        got = distributed.exchange(sends, [r for _, r in recvs])
        for (d, _), t in zip(recvs, got):
            out[d] = t.to(devices[d])
    return out


def all_gather(xs: list, devices: list, ranks=None) -> list:
    """`lax.all_gather` (untiled): every shard gets the stack of all
    shards' tensors on its own device (None for another process's shard,
    as `ppermute` takes `ranks`)."""
    owner, me = _owners(xs, ranks)
    if len(set(owner)) == 1:
        return [torch.stack([x.to(d) for x in xs]) for d in devices]
    mine = [i for i, r in enumerate(owner) if r == me]
    got = distributed.allgather_arrays(
        {i: xs[i].detach().cpu().numpy() for i in mine})
    full = torch.stack([torch.from_numpy(got[i]) for i in range(len(xs))])
    return [full.to(d) if r == me else None for d, r in zip(devices, owner)]


def gather_host(mesh: Mesh, pieces: dict) -> dict:
    """The counterpart of `hostio.global_get`: this process's host
    results {key: ndarray} (keys a shard's or a block's index) merged with
    every other process's, so that each process holds all of them. On a
    mesh of one process, `pieces` itself."""
    if not mesh.spans_processes:
        return pieces
    return distributed.allgather_arrays(
        {k: np.ascontiguousarray(v) for k, v in pieces.items()})

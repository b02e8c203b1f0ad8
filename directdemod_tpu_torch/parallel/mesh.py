"""A (time, channel) mesh of shards in one process, and its collectives.

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
"""
from __future__ import annotations

import torch

from ..device import resolve

# The shards a mesh on the CPU has when no count is given: the JAX
# package's tests run on 8 virtual CPU devices (tests/conftest.py).
CPU_DEVICES = 8


class Mesh:
    """`time` x `channel` shards, time-major: `devices[t][c]` is the device
    of shard (t, c)."""

    def __init__(self, devices: list, time: int, channel: int):
        self.devices = [[torch.device(devices[t * channel + c])
                         for c in range(channel)] for t in range(time)]

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

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {self.devices})"


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
    once), time-major. Without a list: `time * channel` shards on `device`
    when both are given, else `visible_devices(device)`. Raises ValueError
    when the shape does not cover the devices exactly."""
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


def single_device_mesh(device=None) -> Mesh:
    return Mesh([resolve(device)], 1, 1)


def ppermute(xs: list, perm: list, devices: list) -> list:
    """`lax.ppermute`: shard d receives xs[s] for each (s, d) in `perm`, as
    a copy on its own device (a copy also when both shards share one, so a
    receiver never aliases its sender); a shard that receives nothing gets
    zeros, as in JAX."""
    out = [torch.zeros_like(x, device=d) for x, d in zip(xs, devices)]
    for s, d in perm:
        out[d] = xs[s].to(devices[d], copy=True)
    return out


def all_gather(xs: list, devices: list) -> list:
    """`lax.all_gather` (untiled): every shard gets the stack of all
    shards' tensors on its own device."""
    return [torch.stack([x.to(d) for x in xs]) for d in devices]

"""The mesh over several processes: `initialize` and `global_wave`.

Port of `directdemod_tpu/parallel/distributed.py:1-32`. In JAX,
`jax.distributed.initialize` turns `jax.devices()` into the devices of all
processes, and one `shard_map` program spans them. Here `initialize` joins
a `torch.distributed` process group and records this process's shard
devices; `parallel.mesh.make_mesh` then lays the `time` shards over the
processes in rank order (process r owns shards [r T/W, (r+1) T/W)), and the
mesh's collectives (`ppermute`, `all_gather`, `gather_host`) move what a
pair of shards on two processes exchanges through this module's transport.

Each process reads only its own blocks of the capture (the range-read
contract of the sources: `read(from, to)`), and `global_wave` hands its
stack of chunks to the mesh as the per-shard list that
`parallel.sharded.ShardedDdcFm._wave` takes.

The process group is gloo's. NCCL refuses two ranks on one card, and one
card is the port's target; gloo's point-to-point calls take CPU tensors
only, so every tensor that crosses processes is staged through host memory
here, explicitly, as raw bytes. The halos are kilobytes, and the outputs go
to the host anyway, as `hostio.global_get` sends them there in JAX.

`launch` starts the worker processes of a multi-process run with
`subprocess` (never `fork`: a parent that has touched CUDA cannot fork a
CUDA child), each with a time limit, and kills them all on a failure.
"""
from __future__ import annotations

import datetime
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

# Seconds a rendezvous or a collective waits for the other processes.
TIMEOUT_S = 120

_local_devices: list | None = None


def initialize(coordinator: str, num_processes: int, process_id: int,
               local_devices=None, device=None,
               timeout_s: float = TIMEOUT_S) -> None:
    """Join the gloo process group at `coordinator` ("host:port", rank 0
    listens there) as `process_id` of `num_processes`, and record this
    process's shard devices: `local_devices` is a count of shards on the
    device rule's device (`device`), or a list of devices; without it,
    `mesh.visible_devices(device)`."""
    global _local_devices
    from .mesh import resolve, visible_devices
    if local_devices is None:
        devs = visible_devices(device)
    elif isinstance(local_devices, int):
        devs = [resolve(device)] * local_devices
    else:
        devs = [torch.device(d) for d in local_devices]
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator}", world_size=num_processes,
        rank=process_id, timeout=datetime.timedelta(seconds=timeout_s))
    _local_devices = devs


def shutdown() -> None:
    """Leave the process group (after the last collective)."""
    global _local_devices
    if dist.is_initialized():
        dist.destroy_process_group()
    _local_devices = None


def is_initialized() -> bool:
    return _local_devices is not None


def local_devices() -> list:
    """This process's shard devices, as `initialize` recorded them."""
    if _local_devices is None:
        raise RuntimeError("distributed.initialize has not been called")
    return list(_local_devices)


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def global_wave(mesh, local_chunks) -> list:
    """This process's (local_count, L) stack of chunks (bytes or complex
    samples, numpy or tensor) as the per-shard list of the mesh's `time`
    axis: each local chunk on its shard's device, None for a shard of
    another process. Raises ValueError when the count is not this
    process's number of `time` shards (as JAX's
    `make_array_from_process_local_data` raises)."""
    mine = mesh.local_time
    if len(local_chunks) != len(mine):
        raise ValueError(f"{len(local_chunks)} local chunks for the "
                         f"{len(mine)} time shards of process {mesh.rank}")
    out = [None] * mesh.shape["time"]
    for i, x in zip(mine, local_chunks):
        x = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))
        out[i] = x.to(mesh.time_devices[i])
    return out


# ------------------------------------------------------------- transport

def _bytes_of(t: torch.Tensor) -> torch.Tensor:
    """A host tensor's contents as a flat uint8 tensor (a copy to the host
    for a device tensor)."""
    flat = torch.empty(t.numel(), dtype=t.dtype)
    flat.copy_(t.detach().reshape(-1))
    return flat.view(torch.uint8)


def exchange(sends: list, recvs: list) -> list:
    """Point-to-point between processes, all posted at once (so a ring
    cannot deadlock): `sends` are (tensor, destination rank, tag),
    `recvs` (a tensor of the shape and dtype to expect, source rank, tag).
    Returns the received tensors, on the host."""
    ops, bufs = [], []
    for t, dst, tag in sends:
        ops.append(dist.P2POp(dist.isend, _bytes_of(t), dst, tag=tag))
    for like, src, tag in recvs:
        buf = torch.empty(like.numel() * like.element_size(), dtype=torch.uint8)
        bufs.append((buf, like))
        ops.append(dist.P2POp(dist.irecv, buf, src, tag=tag))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return [buf.view(like.dtype).reshape(like.shape) for buf, like in bufs]


def _allgather_bytes(data: np.ndarray) -> list:
    """Every process's uint8 array (of any length), in rank order."""
    n = torch.tensor([data.size], dtype=torch.int64)
    sizes = [torch.empty_like(n) for _ in range(world_size())]
    dist.all_gather(sizes, n)
    top = max(int(s) for s in sizes)
    buf = torch.zeros(top, dtype=torch.uint8)
    buf[: data.size] = torch.from_numpy(np.ascontiguousarray(data).reshape(-1))
    bufs = [torch.empty_like(buf) for _ in sizes]
    dist.all_gather(bufs, buf)
    return [b[: int(s)].numpy() for b, s in zip(bufs, sizes)]


def allgather_arrays(pieces: dict) -> dict:
    """Merge every process's {key: host ndarray} into one dict on every
    process (the keys must differ between processes)."""
    keys = sorted(pieces)
    meta = [(k, pieces[k].dtype.str, pieces[k].shape) for k in keys]
    metas = [None] * world_size()
    dist.all_gather_object(metas, meta)
    blob = (np.concatenate([np.ascontiguousarray(pieces[k]).reshape(-1).view(np.uint8)
                            for k in keys]) if keys else np.zeros(0, np.uint8))
    out = {}
    for m, b in zip(metas, _allgather_bytes(blob)):
        pos = 0
        for k, dt, shape in m:
            nbytes = int(np.prod(shape, dtype=np.int64)) * np.dtype(dt).itemsize
            out[k] = b[pos:pos + nbytes].view(dt).reshape(shape)
            pos += nbytes
    return out


# ------------------------------------------------------------- launcher

def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(argvs: list, timeout_s: float = TIMEOUT_S, env: dict | None = None,
           cwd: str | None = None) -> list:
    """Run one Python process a rank, `python <argvs[r]...>`, all at once,
    and wait for them, at most `timeout_s` seconds in all. Returns each
    process's (exit code, stdout + stderr). When one fails, or the time is
    up, every process still running is killed (its exit code reported as
    None): a rank waiting on a dead peer would otherwise wait out the
    collective's own timeout."""
    env = dict(os.environ if env is None else env)
    env.setdefault("PYTHONUNBUFFERED", "1")
    logs = [tempfile.TemporaryFile(mode="w+") for _ in argvs]
    procs = [subprocess.Popen([sys.executable, *argv], env=env, cwd=cwd,
                              stdout=log, stderr=subprocess.STDOUT)
             for argv, log in zip(argvs, logs)]
    deadline = time.monotonic() + timeout_s
    try:
        while time.monotonic() < deadline:
            codes = [p.poll() for p in procs]
            if all(c is not None for c in codes) or any(c not in (None, 0) for c in codes):
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    out = []
    for p, log, killed in zip(procs, logs, [p.returncode < 0 for p in procs]):
        log.seek(0)
        out.append((None if killed else p.returncode, log.read()))
        log.close()
    return out

"""Multi-process runtime helpers, torch port of ``close_kmers_tpu/
parallel/multihost.py``: torch.distributed initialization, the mesh of a
process group, and host-level input sharding.

torch runs one process per card: a process group of N ranks forms one
("data", "table") mesh of N entries, each rank owning its own
(:func:`pod_mesh`), where JAX joins every host's devices into one global
mesh.  The collectives run on NCCL between cards and on gloo on the CPU.

* :func:`initialize`: ``dist.init_process_group`` from arguments or
  torch's standard environment (``RANK``, ``WORLD_SIZE``,
  ``MASTER_ADDR``/``MASTER_PORT``);
* :func:`pod_mesh`: the process group as a mesh;
* :func:`replicate_to_global`: host inputs made identical on every rank
  (a broadcast from rank 0);
* :func:`addressable_rows`: the rows of a step's output that this
  process's own entry computed;
* :func:`host_shard` / :func:`partition_file_ranges` /
  :func:`read_lines_in_range`: deterministic host-level partitioning of
  input work (the reference's parallel_read at process granularity).
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import resolve_device
from .sharding import Mesh


def initialize(device, coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> bool:
    """Join the process group of ``num_processes`` ranks (argument or
    ``WORLD_SIZE``) as rank ``process_id`` (argument or ``RANK``), the
    rendezvous at ``coordinator_address`` "host:port" (argument or
    ``MASTER_ADDR``:``MASTER_PORT``).  NCCL when ``device`` is a card,
    gloo on the CPU.  A process that names no world size (neither
    argument nor ``WORLD_SIZE``) is a single process: nothing is joined
    and it returns False; an explicit world of 1 is a group of one."""
    if num_processes is None:
        if "WORLD_SIZE" not in os.environ:
            return False
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None:
        process_id = int(os.environ["RANK"])
    if coordinator_address is None:
        coordinator_address = (f"{os.environ.get('MASTER_ADDR', '127.0.0.1')}"
                               f":{os.environ['MASTER_PORT']}")
    dev = _entry_device(device, process_id)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id)
    return True


def _entry_device(device, rank: int) -> torch.device:
    """This rank's device: ``device`` itself, or for a bare "cuda" the
    card ``LOCAL_RANK`` (default: the rank modulo the visible cards)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        local = os.environ.get("LOCAL_RANK")
        dev = torch.device("cuda", int(local) if local is not None
                           else rank % torch.cuda.device_count())
    return dev


def pod_mesh(device, n_data: int | None = None,
             n_table: int | None = None) -> Mesh:
    """The ("data", "table") mesh of the initialized process group: rank
    r owns entry ``divmod(r, n_table)`` on ``device``.  Defaults: table
    spans the ranks of one host (``LOCAL_WORLD_SIZE``, else all ranks),
    data the hosts.  Every rank must call it, with the same sizes: it
    creates one process group per data row."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_data is None and n_table is None:
        n_table = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        n_data = world // n_table
    elif n_data is None:
        n_data = world // n_table
    elif n_table is None:
        n_table = world // n_data
    if n_data * n_table != world:
        raise ValueError(f"a {n_data} x {n_table} mesh needs "
                         f"{n_data * n_table} ranks; the group has {world}")
    groups = [None] if n_data == 1 else [
        dist.new_group(list(range(d * n_table, (d + 1) * n_table)))
        for d in range(n_data)]
    devices = [[None] * n_table for _ in range(n_data)]
    d, t = divmod(rank, n_table)
    devices[d][t] = _entry_device(device, rank)
    return Mesh(devices, rank=rank, row_group=groups[d])


def replicate_to_global(mesh: Mesh, *arrays):
    """Host-local numpy inputs made identical on every rank of a
    multi-process mesh (rank 0's values, broadcast; every rank passes
    arrays of the same shapes and dtypes).  A passthrough on a
    one-process mesh."""
    if not mesh.distributed:
        return arrays
    dev = mesh.device(mesh.entries[0])
    out = []
    for a in arrays:
        t = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
        dist.broadcast(t, src=0)
        out.append(t.cpu().numpy())
    return tuple(out)


def addressable_rows(mesh: Mesh, arr, split: str):
    """Yield (index, numpy rows) for each local entry's block of a
    sharded step's global output ``arr`` (``split``: "data" for outputs
    replicated over table, "both" for outputs split over both axes): the
    rows that this process's own entries computed."""
    rows = arr.shape[0] // mesh.n_blocks(split)
    for e in mesh.entries:
        b = mesh.block(e, split)
        idx = (slice(b * rows, (b + 1) * rows),)
        yield idx, arr[idx].cpu().numpy()


def host_shard(items: list, process_id: int | None = None,
               num_processes: int | None = None) -> list:
    """Deterministic round-robin split of a work list across processes
    (defaults: this rank and the group's size; 0 of 1 without a
    group)."""
    up = dist.is_available() and dist.is_initialized()
    pid = process_id if process_id is not None \
        else (dist.get_rank() if up else 0)
    n = num_processes if num_processes is not None \
        else (dist.get_world_size() if up else 1)
    return items[pid::n]


# Copied from close_kmers_tpu/parallel/multihost.py (pure Python).
def partition_file_ranges(file_size: int, n_parts: int) -> list[tuple[int, int]]:
    """Byte ranges for parallel line-oriented reading, parallel_read
    parity (parallel_read.cc:44-94): part i spans [i*sz/n, (i+1)*sz/n);
    a reader discards its first partial line (unless it is part 0) and
    reads past its end boundary to finish its last line."""
    out = []
    for i in range(n_parts):
        a = file_size * i // n_parts
        b = file_size * (i + 1) // n_parts
        out.append((a, b))
    return out


# Copied from close_kmers_tpu/parallel/multihost.py (pure Python).
def read_lines_in_range(path: str, start: int, end: int):
    """Yield the complete lines owned by byte range [start, end):
    skip the partial first line when start > 0; finish the line that
    straddles ``end``."""
    with open(path, "rb") as f:
        f.seek(start)
        if start > 0:
            f.readline()  # discard partial line (owned by previous range)
        while f.tell() < end:
            line = f.readline()
            if not line:
                break
            yield line.decode("latin-1").rstrip("\n")

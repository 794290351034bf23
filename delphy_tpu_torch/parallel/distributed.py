"""More than one device: one process per device with ``torch.distributed``
(port of ``delphy_tpu/parallel/distributed.py``).

The JAX package runs one controller over a ("part",) mesh of devices, or one
process per host under ``jax.distributed``.  The port runs one process (a
"rank") per device, PyTorch's own idiom, which is the JAX package's
multi-process contract taken down to one device a process: every rank runs
the same deterministic host program (global moves, field and salt draws,
topology bursts, repartitions), so replicated values need no broadcast.
Only the partitioned sweep is split: rank r sweeps a contiguous slice of the
part axis (``PartMesh.shard_rows``), and the disjoint per-part deltas are
summed with one all-reduce a boundary (``sweep.mesh_reassemble``).

There is no counterpart of ``replicate_to_mesh`` or
``shard_parts_to_mesh``: every rank holds the whole replicated state and the
whole partition maps on its own device, and gathers its rows from them.

Environment contract (the JAX package's names):
  DELPHY_TPU_COORDINATOR   host:port of rank 0 (a ``tcp://`` rendezvous)
  DELPHY_TPU_NUM_PROCESSES the number of ranks
  DELPHY_TPU_PROCESS_ID    this process's rank
With ``DELPHY_TPU_DISTRIBUTED=1`` and no coordinator, the standard launcher
variables are read instead (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``, as ``torchrun`` sets them).  ``LOCAL_RANK`` (default: the
rank) picks a rank's card and ``LOCAL_WORLD_SIZE`` (default: the number of
ranks) says how many ranks share this host; set both when ranks span hosts.

Backends, by rule: a rank's CUDA tensors go over NCCL when every rank of
the host can have a card of its own, and its CPU tensors over gloo.  Ranks
that share a card, or run on the CPU, reassemble over gloo; on a shared
card the packed buffer is staged through the host, one copy each way.  A
rendezvous or collective that fails raises; collectives time out after
``COLLECTIVE_TIMEOUT``.  ``spawn`` starts ranks on this host and, when one
fails, stops the others.

The kernels' libraries build safely when two ranks reach ``_build/`` at
once (each build writes a file of its own and renames it into place), but
``spawn``'s callers build them first so that N ranks do not run N nvcc.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import socket
import sys

import torch
import torch.distributed as dist

from .. import DEFAULT_DEVICE

COLLECTIVE_TIMEOUT = datetime.timedelta(minutes=10)


def distributed_requested() -> bool:
    return bool(os.environ.get("DELPHY_TPU_COORDINATOR")
                or os.environ.get("DELPHY_TPU_DISTRIBUTED"))


def _backend(world: int) -> str:
    """NCCL for CUDA tensors where this host's ranks can each have a card,
    gloo for CPU tensors (and for every tensor where they cannot)."""
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if torch.cuda.is_available() and \
            local_world <= torch.cuda.device_count():
        return "cpu:gloo,cuda:nccl"
    return "gloo"


def initialize_from_env() -> bool:
    """Start the process group from the env contract above.  Returns True
    when a group was started (idempotent: a second call returns True and
    starts nothing).  Call it before anything else touches a device."""
    if not distributed_requested():
        return False
    if dist.is_initialized():
        return True
    coord = os.environ.get("DELPHY_TPU_COORDINATOR")
    if coord:
        try:
            world = int(os.environ["DELPHY_TPU_NUM_PROCESSES"])
            rank = int(os.environ["DELPHY_TPU_PROCESS_ID"])
        except KeyError as e:
            raise RuntimeError(f"DELPHY_TPU_COORDINATOR is set but {e} is "
                               f"not") from None
        dist.init_process_group(_backend(world), init_method=f"tcp://{coord}",
                                world_size=world, rank=rank,
                                timeout=COLLECTIVE_TIMEOUT)
    else:
        world = int(os.environ["WORLD_SIZE"])
        dist.init_process_group(_backend(world), init_method="env://",
                                timeout=COLLECTIVE_TIMEOUT)
    return True


def shutdown() -> None:
    """Destroy the process group, if one was started."""
    if dist.is_initialized():
        dist.destroy_process_group()


@dataclasses.dataclass(frozen=True)
class PartMesh:
    """The port's ("part",) mesh: ``size`` ranks, this process's ``rank``,
    the process ``group`` and the rank's ``device``.  ``staged``: the ranks
    share one card, and a CUDA buffer is reduced over gloo through the
    host.  ``Run`` reads only ``size`` and ``device`` while it is built, so
    a record with ``group=None`` gives the part-axis padding of a mesh
    without a process group."""
    size: int
    rank: int
    group: object
    device: torch.device
    staged: bool = False

    def shard_rows(self, P: int) -> slice:
        """This rank's contiguous rows of a part axis of width P: [r P/D,
        (r + 1) P/D), the JAX mesh's P("part") sharding in device order."""
        if P % self.size:
            raise ValueError(f"part axis {P} does not divide over "
                             f"{self.size} ranks")
        w = P // self.size
        return slice(self.rank * w, (self.rank + 1) * w)

    def all_reduce_sum(self, buf: torch.Tensor) -> torch.Tensor:
        """``buf`` summed over the ranks (in place where it is not staged)."""
        if self.staged and buf.is_cuda:
            host = buf.cpu()
            dist.all_reduce(host, group=self.group)
            return host.to(buf.device)
        dist.all_reduce(buf, group=self.group)
        return buf

    def disagreeing(self, values: dict) -> list:
        """Names of the ``values`` (host floats) that differ between ranks:
        one all-reduce of MIN and one of MAX over the host."""
        lo = torch.tensor(list(values.values()), dtype=torch.float64)
        hi = lo.clone()
        dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=self.group)
        dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=self.group)
        return [k for k, a, b in zip(values, lo.tolist(), hi.tolist())
                if not a == b]


def global_part_mesh(max_devices: int | None = None,
                     device=DEFAULT_DEVICE) -> PartMesh:
    """The mesh over every rank of the started process group.  ``device``
    ``cuda`` puts rank r on ``cuda:LOCAL_RANK``, a card of its own; a
    device with an index (``cuda:0``) is shared by every rank, and ``cpu``
    keeps the ranks on the CPU.  The mesh is always the whole group: a
    group larger than ``max_devices`` raises instead of leaving ranks
    idle."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call initialize_from_env() "
                           "under the env contract, or start ranks with "
                           "spawn()")
    size, rank = dist.get_world_size(), dist.get_rank()
    if max_devices is not None and size > max_devices:
        raise ValueError(f"{size} ranks were started for a mesh of at most "
                         f"{max_devices}")
    dev = torch.device(device)
    staged = False
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA device requested but torch.cuda is not "
                               "available")
        if dev.index is None:
            local = int(os.environ.get("LOCAL_RANK", rank))
            if local >= torch.cuda.device_count():
                raise RuntimeError(
                    f"rank {rank}: LOCAL_RANK {local} but "
                    f"{torch.cuda.device_count()} cards visible (ranks that "
                    f"share a card name it, e.g. cuda:0)")
            dev = torch.device("cuda", local)
        else:
            staged = size > 1
        torch.cuda.set_device(dev)
    return PartMesh(size=size, rank=rank, group=dist.group.WORLD, device=dev,
                    staged=staged)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, fn, world: int, port: int, args: tuple) -> None:
    os.environ.update({
        "DELPHY_TPU_COORDINATOR": f"127.0.0.1:{port}",
        "DELPHY_TPU_NUM_PROCESSES": str(world),
        "DELPHY_TPU_PROCESS_ID": str(rank),
        "LOCAL_RANK": str(rank), "LOCAL_WORLD_SIZE": str(world)})
    rc = fn(*args)
    if rc:
        sys.exit(rc)


def spawn(fn, nprocs: int, args: tuple = ()) -> None:
    """Run ``fn(*args)`` in ``nprocs`` new processes on this host, ranks 0
    to nprocs - 1 of one group under the env contract (a free localhost
    port; rank r has LOCAL_RANK r).  ``fn`` calls ``initialize_from_env``
    itself; a non-zero return is the rank's exit code.  Returns when every
    rank has ended; when one fails, the others are stopped and
    ``torch.multiprocessing.ProcessException`` is raised."""
    import torch.multiprocessing as mp
    mp.start_processes(_rank_main, args=(fn, nprocs, _free_port(), args),
                       nprocs=nprocs, join=True, start_method="spawn")

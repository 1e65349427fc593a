"""Multi-process runs on ``torch.distributed`` (counterpart of
``tpumcia.parallel.distributed``), and the collectives the sharded feature
path uses.

* every process calls :func:`init_distributed` first. The topology comes
  from the arguments, else from ``TPUMCIA_COORDINATOR`` (``host:port``, or
  an init-method URL such as ``file:///shared/store``),
  ``TPUMCIA_NUM_PROCESSES`` and ``TPUMCIA_PROCESS_ID`` (``launch_eval.sh``'s
  variables), else from torchrun's ``MASTER_ADDR``, ``MASTER_PORT``,
  ``WORLD_SIZE``, ``RANK`` and ``LOCAL_RANK``;
* a mesh built afterwards (``parallel.mesh``) spans every rank's devices, so
  ``MeshConfig(data=-1)`` runs over all of them unchanged;
* per-process rows become one global batch through
  :func:`shard_across_processes`.

The collectives below join the per-slot results: within a process by
copying to the first slot's device, across ranks over the group's backend.
NCCL keeps tensors on the card; gloo gathers and barriers only host
tensors, so under gloo every collective goes through the CPU.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from datetime import timedelta
from typing import Any

import torch


def _dist():
    import torch.distributed as dist

    return dist


def is_initialized() -> bool:
    """True inside a ``torch.distributed`` process group."""
    dist = _dist()
    return dist.is_available() and dist.is_initialized()


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_device_ids=None,
    *,
    backend: str | None = None,
    timeout_s: float = 300.0,
) -> bool:
    """Join the ``torch.distributed`` process group (idempotent).

    Returns True when the run spans several processes after the call, False
    for a single process (no coordinator configured anywhere). ``backend``:
    None picks NCCL where CUDA is present and gloo on the CPU. The process's
    CUDA device is ``local_device_ids[0]``, else ``LOCAL_RANK``, else 0; it
    becomes the current device before the group forms, so a bare ``"cuda"``
    names it. A rank that cannot rendezvous raises after ``timeout_s``.
    """
    dist = _dist()
    if is_initialized():
        return dist.get_world_size() > 1

    env = os.environ
    coordinator_address = coordinator_address or env.get("TPUMCIA_COORDINATOR")
    if num_processes is None and "TPUMCIA_NUM_PROCESSES" in env:
        num_processes = int(env["TPUMCIA_NUM_PROCESSES"])
    if process_id is None and "TPUMCIA_PROCESS_ID" in env:
        process_id = int(env["TPUMCIA_PROCESS_ID"])
    torchrun = all(k in env for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"))
    if coordinator_address is None and torchrun:
        coordinator_address = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
        num_processes = int(env["WORLD_SIZE"]) if num_processes is None else num_processes
        process_id = int(env["RANK"]) if process_id is None else process_id
    if coordinator_address is None:
        if num_processes is not None or process_id is not None:
            # a partially-specified topology must raise, not silently
            # degrade to single-process (every worker would then compute on
            # 1/N of the data and report wrong results)
            raise ValueError(
                "init_distributed: num_processes/process_id were specified "
                f"(num_processes={num_processes}, process_id={process_id}) "
                "but no coordinator address is configured and this is not a "
                "torchrun launch — pass coordinator_address or export "
                "TPUMCIA_COORDINATOR"
            )
        return False  # single-process run; nothing to initialize
    if num_processes is None or process_id is None:
        raise ValueError(
            f"init_distributed: coordinator {coordinator_address!r} needs both "
            f"num_processes and process_id (got {num_processes}, {process_id})"
        )

    if torch.cuda.is_available():
        local = (local_device_ids[0] if local_device_ids
                 else int(env.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(local)
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    dist.init_process_group(
        backend=backend, init_method=url, world_size=int(num_processes),
        rank=int(process_id), timeout=timedelta(seconds=timeout_s),
    )
    return dist.get_world_size() > 1


def backend_of(group) -> str:
    """The group's backend, or ``"none"`` without one."""
    return "none" if group is None else str(_dist().get_backend(group))


def _wire_device(group) -> torch.device:
    """Where a collective over ``group`` takes its tensors: the rank's card
    under NCCL, the CPU under gloo."""
    if backend_of(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's rows of ``t`` (any count, the same trailing shape and
    dtype), joined in rank order, on ``t``'s device. ``group`` None: ``t``."""
    if group is None:
        return t
    dist = _dist()
    world = dist.get_world_size(group)
    wire = _wire_device(group)
    x = t.to(wire).contiguous()
    count = torch.tensor([x.shape[0]], dtype=torch.int64, device=wire)
    counts = [torch.empty_like(count) for _ in range(world)]
    dist.all_gather(counts, count, group=group)
    counts = [int(c) for c in counts]
    padded = x.new_zeros((max(counts), *x.shape[1:]))
    padded[: x.shape[0]] = x
    parts = [torch.empty_like(padded) for _ in range(world)]
    dist.all_gather(parts, padded, group=group)
    return torch.cat([p[:c] for p, c in zip(parts, counts)]).to(t.device)


def _all_reduce(t: torch.Tensor, group, op) -> torch.Tensor:
    if group is None:
        return t
    dist = _dist()
    x = t.to(_wire_device(group)).contiguous().clone()
    dist.all_reduce(x, op=getattr(dist.ReduceOp, op), group=group)
    return x.to(t.device)


def all_reduce_min(t: torch.Tensor, group) -> torch.Tensor:
    """Elementwise min of ``t`` over the group's ranks."""
    return _all_reduce(t, group, "MIN")


def all_reduce_max(t: torch.Tensor, group) -> torch.Tensor:
    """Elementwise max of ``t`` over the group's ranks."""
    return _all_reduce(t, group, "MAX")


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """Elementwise sum of ``t`` over the group's ranks (gradients, counts)."""
    return _all_reduce(t, group, "SUM")


def barrier(group=None) -> None:
    """Wait for every rank of ``group`` (None: the default group). NCCL
    needs the rank's device for it."""
    dist = _dist()
    if backend_of(dist.group.WORLD if group is None else group) == "nccl":
        dist.barrier(group=group, device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier(group=group)


@dataclass(frozen=True)
class ShardedRows:
    """This process's block of a batch whose rows are spread over the
    ranks: ``rows`` (numpy or a tensor), the global index of its first row
    and the rows over all ranks."""

    rows: Any
    offset: int
    total: int


def shard_across_processes(x, mesh, axis: str = "data") -> ShardedRows:
    """Tag this process's local rows ``x`` with their place in the global
    batch, the concatenation of every rank's rows in rank order (the
    multi-process feed for the sharded functions). A collective over the
    mesh's group. Rows go over the ``data`` axis: an axis the mesh lacks is
    refused with tpumcia's message, and ``model``, which tpumcia accepts,
    too (the port's mesh splits rows over ``data`` only)."""
    if axis != "data":
        if axis not in mesh.shape:
            raise ValueError(
                f"Resource axis: {axis} of PartitionSpec({axis!r},) is not found in "
                f"mesh: {tuple(mesh.shape)}."
            )
        raise ValueError(
            f"shard_across_processes splits rows over the 'data' axis only; got axis={axis!r}"
        )
    n = len(x)
    if mesh.group is None:
        return ShardedRows(x, 0, n)
    counts = all_gather_rows(torch.tensor([n], dtype=torch.int64), mesh.group).tolist()
    rank = mesh.rank
    return ShardedRows(x, int(sum(counts[:rank])), int(sum(counts)))


def process_summary() -> dict:
    """Small observability blob for logs: process/device topology (every
    process is taken to hold as many devices as this one)."""
    dist = _dist()
    on = is_initialized()
    local = torch.cuda.device_count() if torch.cuda.is_available() else 1
    count = dist.get_world_size() if on else 1
    return {
        "process_index": dist.get_rank() if on else 0,
        "process_count": count,
        "local_devices": local,
        "global_devices": local * count,
        "backend": backend_of(dist.group.WORLD) if on else "none",
    }

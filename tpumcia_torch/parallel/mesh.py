"""Device meshes (counterpart of ``tpumcia.parallel.mesh``).

A :class:`Mesh` is the port's ``jax.sharding.Mesh``: the ``data`` axis is
a list of slots, each the (rank, device) that computes one block of the
batch (objects are independent of each other). ``model`` is kept as a
shape: each data index computes on its row's first device, and the CNN path
keeps its classifier whole on every replica where tpumcia splits it over
``model`` (the same numbers; ROADMAP, Known divergences). A device pool (:func:`device_pool`) takes
the place of ``jax.devices()``: the devices this process was given, and
under a ``torch.distributed`` process group every rank's pool, gathered in
rank order. A pool may name one device more than once (``["cpu"] * 8``,
``["cuda:0", "cuda:0"]``): its slots then run one after the other on it,
which lays out a mesh on a host with fewer devices than slots.

:func:`data_sharding` and :func:`replicated` return a :class:`Sharding`,
the port's ``NamedSharding``: rows over the data axis (each slot's rows are
:func:`row_ranges`) or the whole array on every slot, which
``parallel.sharding.place_global`` and ``local_to_global`` read.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from tpumcia_torch.parallel.distributed import is_initialized


@dataclass(frozen=True, eq=False)
class Mesh:
    """``shape``: ``{"data": d, "model": m}``; ``slots``: the (rank,
    ``torch.device``) of each data index, in order (a rank's slots are
    contiguous); ``group``: the ``torch.distributed`` process group the
    slots span, or None within one process."""

    shape: dict
    slots: tuple
    group: Any = None

    @property
    def rank(self) -> int:
        """This process's rank in ``group`` (0 without one)."""
        if self.group is None:
            return 0
        import torch.distributed as dist

        return dist.get_rank(self.group)

    def local_slots(self) -> list[int]:
        """The data indices this process computes."""
        me = self.rank
        return [i for i, (r, _) in enumerate(self.slots) if r == me]

    @property
    def first_device(self) -> torch.device:
        """The device of this process's first slot: where its results are
        joined."""
        return self.slots[self.local_slots()[0]][1]

    @property
    def spans_processes(self) -> bool:
        return len({r for r, _ in self.slots}) > 1


@dataclass(frozen=True)
class Sharding:
    """A placement over ``mesh``: ``spec`` ``("data",)`` puts the rows over
    the data axis, ``()`` the whole array on every slot."""

    mesh: Mesh
    spec: tuple


def data_sharding(mesh: Mesh) -> Sharding:
    """Rows over ``mesh``'s data axis (tpumcia's ``P("data")``)."""
    return Sharding(check_mesh(mesh), ("data",))


def replicated(mesh: Mesh) -> Sharding:
    """The whole array on every slot of ``mesh`` (tpumcia's ``P()``)."""
    return Sharding(check_mesh(mesh), ())


def device_pool(device) -> list[torch.device]:
    """This process's devices from one device or a sequence of them. A bare
    ``"cuda"`` stands for every visible CUDA device, or for the current one
    under a process group (``init_distributed`` sets it per rank);
    ``"cuda:k"`` and ``"cpu"`` stand for themselves."""
    if isinstance(device, (list, tuple)):
        return [d for spec in device for d in device_pool(spec)]
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        if is_initialized():
            return [torch.device("cuda", torch.cuda.current_device())]
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev]


def _global_slots(devices) -> tuple[tuple, Any]:
    """((rank, device) of every pool entry over all ranks, the group)."""
    import torch.distributed as dist

    pool = device_pool("cuda" if devices is None else devices)
    if not is_initialized():
        return tuple((0, d) for d in pool), None
    gathered = [None] * dist.get_world_size()
    dist.all_gather_object(gathered, [str(d) for d in pool])
    slots = tuple((r, torch.device(d)) for r, names in enumerate(gathered) for d in names)
    return slots, dist.group.WORLD


def _resolve(data: int, model: int, n: int, prefix: str) -> int:
    """tpumcia's axis checks and ``data=-1`` rule -> the data axis size."""
    if model <= 0:
        raise ValueError(f"{prefix}model axis size must be >= 1")
    if data <= 0 and data != -1:
        raise ValueError(
            f"{prefix}data axis size must be >= 1 (or -1 for 'all remaining'), got {data}"
        )
    if data == -1:
        if n % model:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    return data


def _build(data: int, model: int, slots, group) -> Mesh:
    n = len(slots)
    if data * model > n:
        raise ValueError(f"mesh {data}x{model} needs {data * model} devices, have {n}")
    # a (data, model) grid over the first data*model devices; each data
    # index computes on its row's first device (the feature path replicates
    # over the model axis)
    chosen = tuple(slots[i * model] for i in range(data))
    idle = sorted({r for r, _ in slots} - {r for r, _ in chosen})
    if idle:
        # a rank without a slot would still have to join every collective
        raise ValueError(
            f"mesh {data}x{model} over {n} devices leaves rank(s) {idle} "
            "without a data slot; every process of the group must hold one"
        )
    return Mesh(shape={"data": data, "model": model}, slots=chosen, group=group)


def check_mesh(mesh) -> Mesh:
    """``mesh`` if it is a :class:`Mesh`, else a ``TypeError``."""
    if not isinstance(mesh, Mesh):
        raise TypeError(
            "mesh must be a tpumcia_torch.parallel.Mesh (make_mesh or "
            f"mesh_from_config); got {type(mesh).__name__}"
        )
    return mesh


def make_mesh(data: int = -1, model: int = 1, devices=None) -> Mesh:
    """A (data, model) mesh over the pool ``devices`` (one device or a
    sequence; None: every visible CUDA device), gathered over the ranks of
    a process group when one is initialized (a collective: every rank calls
    it)."""
    slots, group = _global_slots(devices)
    data = _resolve(data, model, len(slots), "")
    return _build(data, model, slots, group)


def mesh_from_config(cfg, devices=None) -> Mesh | None:
    """Resolve a :class:`tpumcia_torch.config.MeshConfig` against the pool
    ``devices`` into a Mesh, or None for a single-device layout (data *
    model <= 1). ``data=-1`` means every device left after the model axis:
    one card (or the CPU) resolves to None and runs unsharded."""
    data, model = cfg.data, cfg.model
    if data >= 1 and data * model == 1:
        _resolve(data, model, 1, "mesh config: ")
        return None  # one device whatever the pool: no collective needed
    slots, group = _global_slots(devices)
    data = _resolve(data, model, len(slots), "mesh config: ")
    if data * model <= 1:
        return None
    return _build(data, model, slots, group)


def split_rows(n: int, parts: int) -> list[tuple[int, int]]:
    """tpumcia's split of ``n`` rows into ``parts`` blocks: ceil(n / parts)
    rows a block, in order, the last blocks short (or empty)."""
    per = -(-n // parts)
    return [(min(i * per, n), min((i + 1) * per, n)) for i in range(parts)]


def row_ranges(n: int, mesh: Mesh) -> list[tuple[int, int]]:
    """The (start, stop) rows of each data slot of ``mesh`` in a batch of
    ``n`` (:func:`split_rows` over the data axis)."""
    return split_rows(n, mesh.shape["data"])

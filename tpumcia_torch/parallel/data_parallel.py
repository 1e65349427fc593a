"""Data-parallel training over a device mesh: the port's counterpart of
tpumcia's sharded train step (``tpumcia.models.train``: the batch at
``P("data")``, XLA's gradient psum), with the reduction written out.

The contract, per step of a global batch of ``bs`` rows:

* **replicas**: one copy of the model per *distinct* device among this
  process's slots (:func:`replicate`); slots that share a device run on one
  replica, one after the other, which is how one card lays out a two-slot
  mesh. The first slot's replica is the primary: the optimizer steps it;
* **rows**: each slot takes its block of the batch by
  :func:`parallel.mesh.row_ranges`. There are no pad rows: the last blocks
  may be short or empty, and an empty block runs no forward pass;
* **loss**: a block's loss is the summed cross-entropy of its rows over
  ``bs``, so the blocks of every slot and rank sum to the batch mean;
* **reduction** (:func:`reduce_gradients`): backward accumulates the
  gradients of a replica's slots in slot order; the replicas' gradients are
  flattened into one float32 buffer on the first slot's device and summed
  there in slot order, the summed loss in its last word; the buffer is
  all-reduced (SUM) over the mesh's process group (NCCL on the card, gloo
  through the CPU) and written back as the primary's gradients;
* **step** (:func:`data_parallel_step`): one optimizer step on the primary,
  then its parameters are copied to the other local replicas.

Every rank starts from the same weights (a seeded CPU generator) and takes
the same batches (numpy's epoch order), so after the all-reduce every rank
holds the same gradients and steps to the same weights. The model axis
computes on each data row's first device: the classifier is not split
(ROADMAP, Known divergences). DDP is not used: it takes one device per
process, where a :class:`parallel.mesh.Mesh` may lay several slots on one
process.
"""

from __future__ import annotations

import copy

import torch
import torch.nn.functional as F
from torch import nn

from tpumcia_torch.parallel.distributed import all_reduce_sum
from tpumcia_torch.parallel.mesh import Mesh, row_ranges


def replicate(model: nn.Module, mesh: Mesh) -> dict[torch.device, nn.Module]:
    """{device: replica} over this process's slots in slot order: ``model``
    itself on the first slot's device (where it must lie), a copy on each
    other distinct device."""
    first = mesh.first_device
    here = next(model.parameters()).device
    if here != first:
        raise ValueError(f"the model lies on {here}; the mesh's first local slot is on {first}")
    replicas = {first: model}
    for s in mesh.local_slots():
        dev = mesh.slots[s][1]
        if dev not in replicas:
            replicas[dev] = copy.deepcopy(model).to(dev, memory_format=torch.channels_last)
    return replicas


def local_blocks(n: int, mesh: Mesh, replicas: dict) -> list[tuple[nn.Module, torch.device, int, int]]:
    """(replica, device, start, stop) of each of this process's slots in a
    batch of ``n`` rows, in slot order (empty blocks included)."""
    ranges = row_ranges(n, mesh)
    return [(replicas[mesh.slots[s][1]], mesh.slots[s][1], *ranges[s]) for s in mesh.local_slots()]


def reduce_gradients(replicas: dict, mesh: Mesh, images: torch.Tensor, y_idx: torch.Tensor) -> torch.Tensor:
    """Forward and backward of each local slot's block of the batch
    (``images`` and ``y_idx`` whole, on any device), then the gradient
    reduction of the module docstring; leaves the batch's gradients in the
    primary replica's ``.grad`` and returns the batch's mean loss (0-d, on
    the first slot's device)."""
    bs = len(y_idx)
    first = mesh.first_device
    for model in replicas.values():
        model.zero_grad(set_to_none=True)
    loss = torch.zeros((), dtype=torch.float32, device=first)
    for model, dev, a, b in local_blocks(bs, mesh, replicas):
        if a == b:
            continue
        block = F.cross_entropy(model(images[a:b].to(dev)), y_idx[a:b].to(dev), reduction="sum") / bs
        block.backward()
        loss = loss + block.detach().to(first)
    flat = None
    for model in replicas.values():
        grads = [p.grad for p in model.parameters()]
        if grads[0] is None:  # every slot of this replica was empty
            continue
        g = torch.cat([t.reshape(-1) for t in grads]).to(first)
        flat = g if flat is None else flat + g
    primary = replicas[first]
    params = list(primary.parameters())
    if flat is None:
        flat = torch.zeros(sum(p.numel() for p in params), dtype=torch.float32, device=first)
    buf = all_reduce_sum(torch.cat([flat, loss.reshape(1)]), mesh.group)
    offset = 0
    for p in params:
        p.grad = buf[offset:offset + p.numel()].view(p.shape)
        offset += p.numel()
    return buf[-1].clone()  # not a view: a caller keeping the loss must not keep the buffer


def data_parallel_step(replicas: dict, optimizer: torch.optim.Optimizer, mesh: Mesh,
                       images: torch.Tensor, y_idx: torch.Tensor) -> torch.Tensor:
    """One optimizer step over the mesh (the module docstring's contract);
    returns the batch's mean loss before the step."""
    loss = reduce_gradients(replicas, mesh, images, y_idx)
    optimizer.step()
    primary = replicas[mesh.first_device]
    with torch.no_grad():  # the other local replicas take the primary's new weights
        for model in replicas.values():
            if model is not primary:
                for dst, src in zip(model.parameters(), primary.parameters()):
                    dst.copy_(src)
    return loss

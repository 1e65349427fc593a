"""Host arrays to a CUDA device, and device results back, beside the compute
stream.

Large collections stay on the host and cross one batch at a time
(``extract_features_pending``, ``stream_extract``):

- :class:`HostStager` copies a batch into one of a small ring of pinned
  buffers and sends it with ``non_blocking=True`` on a side stream, so the
  upload of batch i+1 runs while the kernels of batch i do. A buffer is
  reused only after the event behind its copy has completed. It hands back
  a :class:`Staged` tensor; :func:`take` makes the consumer's stream wait
  for the copy's event and tells the allocator that the tensor is used
  there (``record_stream``).
- :class:`HostFetch` is the other direction: an event behind a result on
  the compute stream, the copy into pinned memory on a copy stream that
  waits for that event only, and a wait on the copy's own event. A plain
  ``.cpu()`` would wait for everything queued on the compute stream, the
  next batch included.

A CPU device needs neither: :func:`rows_to_device` wraps the rows, and
:meth:`HostFetch.numpy` reads the tensor.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

_TORCH_DTYPES = {np.dtype(np.uint8): torch.uint8, np.dtype(np.int32): torch.int32}


@dataclass
class Staged:
    """A tensor allocated and filled on a side stream, with the event
    recorded behind its copy."""

    tensor: torch.Tensor
    event: "torch.cuda.Event"


def take(x):
    """A tensor, or a :class:`Staged` one made usable on the current stream
    of its device."""
    if not isinstance(x, Staged):
        return x
    cur = torch.cuda.current_stream(x.tensor.device)
    cur.wait_event(x.event)
    x.tensor.record_stream(cur)
    return x.tensor


class HostStager:
    """One side stream on ``device`` and, for each kind of array (``ring``:
    the images, the masks), a ring of ``slots`` pinned host buffers, so a
    buffer keeps one size. :meth:`put` may be called from any one thread at
    a time (a prefetch worker, or the consumer itself)."""

    def __init__(self, device, slots: int = 2):
        self.device = torch.device(device)
        if self.device.type != "cuda":
            raise ValueError(f"HostStager stages to a CUDA device; got {self.device}")
        self.stream = torch.cuda.Stream(self.device)
        self._slots = max(1, slots)
        self._rings: dict = {}  # ring -> [buffers, events, next slot]

    def put(self, parts, dtype, ring: str = "images") -> Staged:
        """Host arrays ``parts`` (equal trailing shapes), joined along axis
        0 and converted to ``dtype`` (uint8 or int32) as they are copied
        into a pinned buffer of ``ring`` -> the :class:`Staged` tensor on
        the device."""
        dtype = np.dtype(dtype)
        rows = sum(len(p) for p in parts)
        shape = (rows, *parts[0].shape[1:])
        nbytes = math.prod(shape) * dtype.itemsize
        state = self._rings.setdefault(ring, [[None] * self._slots, [None] * self._slots, 0])
        buffers, events, slot = state
        state[2] = (slot + 1) % self._slots
        if events[slot] is not None:
            events[slot].synchronize()  # the copy that last read this buffer
        buf = buffers[slot]
        if buf is None or buf.numel() < nbytes:
            buf = buffers[slot] = torch.empty(max(nbytes, 1), dtype=torch.uint8, pin_memory=True)
        host = buf[:nbytes].view(_TORCH_DTYPES[dtype]).view(shape)
        dst, row = host.numpy(), 0
        for p in parts:
            np.copyto(dst[row:row + len(p)], p, casting="unsafe")
            row += len(p)
        # the calling thread may never have selected the device
        with torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            tensor = host.to(self.device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self.stream)
        events[slot] = event
        return Staged(tensor, event)


def rows_to_device(parts, device, dtype, stager: HostStager | None = None, ring: str = "images"):
    """Host arrays ``parts`` joined along axis 0 as ``dtype`` on ``device``:
    through ``stager``'s ``ring`` (a :class:`Staged` tensor, asynchronous)
    when one is given, else by a plain copy that the caller's stream waits
    for."""
    if stager is not None:
        return stager.put(parts, dtype, ring)
    host = parts[0] if len(parts) == 1 else np.concatenate(parts)
    host = np.ascontiguousarray(host.astype(dtype, copy=False))
    return torch.from_numpy(host).to(device)


class HostFetch:
    """The copy of a device result to the host, started behind the work
    that produces it and waited for on its own. Its pinned block comes from
    torch's caching host allocator, which hands a freed block of the size
    out again: the results are a few MB and all of one size, so no ring is
    kept for them."""

    def __init__(self, tensor: torch.Tensor, copy_stream=None):
        self._event = None
        if tensor.device.type != "cuda":
            self._host = tensor
            return
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(tensor.device))  # behind the result
        with torch.cuda.stream(copy_stream):
            copy_stream.wait_event(done)
            self._host = torch.empty(tensor.shape, dtype=tensor.dtype, pin_memory=True)
            self._host.copy_(tensor, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(copy_stream)
        tensor.record_stream(copy_stream)

    def numpy(self) -> np.ndarray:
        """Wait for this copy alone; the array on the host."""
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()

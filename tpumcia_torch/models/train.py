"""CNN training on one device or over a device mesh (counterpart of
``tpumcia.models.train``).

:func:`fit_cnn` trains the ResNet of ``models/cnn.py`` with AdamW on softmax
cross-entropy. What is kept from tpumcia so that the two can be compared:

* the epoch order: ``np.random.default_rng(seed).permutation(n)`` per epoch,
  padded with wrap-around samples to whole batches, so every sample trains in
  every epoch and every step has one shape (numpy, hence the same order);
* ``optax.adamw``'s update: ``torch.optim.AdamW(eps=1e-8)`` over every
  parameter, the norms' scales and biases included;
* the dataset stays on the device and each batch is gathered there; the loss
  is fetched once at the end unless ``verbose`` or an eval set asks for it;
* integer images are divided by 255 on the device.

The initial weights have tpumcia's distributions but not its draws
(``cnn.init_parameters``); a test hands one set of weights to both packages.
Over a ``parallel.Mesh`` each step splits the batch over the data slots and
sums the gradients by hand (``parallel.data_parallel``); with several
processes, tpumcia's contract holds: every rank passes the same full
``(images, labels)``, and the seeded CPU generator gives every rank the same
initial weights, so no broadcast is needed. :class:`CNNHead` over a mesh
splits the rows of its inference entry points over the slots and gathers
them over the ranks. Checkpoints are one ``torch.save`` file of tensors and
plain values, read with ``weights_only=True``; tpumcia's Orbax directories
are not read.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.nn.functional as F

from tpumcia_torch.features.stats import on_device
from tpumcia_torch.models.cnn import ResNet, init_parameters, make_resnet
from tpumcia_torch.parallel.data_parallel import data_parallel_step, local_blocks, replicate
from tpumcia_torch.parallel.distributed import all_gather_rows, all_reduce_sum, barrier
from tpumcia_torch.parallel.mesh import Mesh, check_mesh
from tpumcia_torch.utils.device import require_device

# images per forward pass of the inference entry points: logits do not depend
# on the batch they were computed in (GroupNorm has no batch statistics; the
# library's kernel choice by row count moves them by float32 ulps at most),
# and a chunk bounds the activations' memory
PREDICT_CHUNK = 1024


@dataclass
class CNNConfig:
    num_classes: int
    width: int = 64
    depth: str = "18"
    learning_rate: float = 1e-3
    weight_decay: float = 1e-4
    batch_size: int = 64
    epochs: int = 5
    seed: int = 0


def images_on_device(images, device, *, int_max: float | None = 255.0) -> torch.Tensor:
    """(B, H, W, C) images, numpy or a tensor -> float32 on ``device``;
    integer images are divided there by ``int_max`` (255, ``fit_cnn``'s
    levels) or, with None, by their dtype's maximum."""
    x = on_device(images, device)
    if x.dtype.is_floating_point:
        return x.to(torch.float32)
    return x.to(torch.float32) / (float(torch.iinfo(x.dtype).max) if int_max is None else int_max)


@dataclass
class CNNHead:
    model: ResNet
    classes: np.ndarray
    config: CNNConfig | None = None
    history: list = field(default_factory=list)
    mesh: Mesh | None = None
    replicas: dict | None = field(default=None, repr=False)

    is_device: bool = True

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def forward(self, x: torch.Tensor, model: ResNet | None = None) -> torch.Tensor:
        """Logits of float32 (B, H, W, C) images already on the device of
        ``model`` (default: the head's), in one pass, without gradients."""
        with torch.no_grad():
            return (model or self.model)(x)

    def apply_fn(self):
        """tpumcia's scoring callable: ``f(images)``, float32 (B, H, W, C)
        images on the head's device -> logits (:meth:`forward`)."""
        return self.forward

    def chunks(self, n: int, size: int = PREDICT_CHUNK):
        """(model, device, start, stop) of each chunk of at most ``size``
        rows that this process computes in a batch of ``n``: all of them on
        the head's model without a mesh, each local slot's block on its
        device's replica with one."""
        if self.mesh is None:
            blocks = [(self.model, self.device, 0, n)]
        else:
            if self.replicas is None:
                self.replicas = replicate(self.model, self.mesh)
            blocks = local_blocks(n, self.mesh, self.replicas)
        for model, dev, a, b in blocks:
            for s in range(a, b, size):
                yield model, dev, s, min(s + size, b)

    def gather_rows(self, parts: list[torch.Tensor]) -> torch.Tensor:
        """This process's per-block results joined in row order on the
        head's device, then every rank's (so every rank holds every row)."""
        out = torch.cat([p.to(self.device) for p in parts])
        return out if self.mesh is None else all_gather_rows(out, self.mesh.group)

    def sum_over_ranks(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the ranks of the head's mesh (counts)."""
        return t if self.mesh is None else all_reduce_sum(t, self.mesh.group)

    def predict_logits(self, images) -> torch.Tensor:
        """(B, num_classes) float32 logits on the head's device, computed
        :data:`PREDICT_CHUNK` images at a time (over a mesh, each slot its
        rows; every rank gets every row)."""
        x = images if isinstance(images, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(images))
        if x.dim() != 4:
            raise ValueError(f"expected (B, H, W, C) images; got shape {tuple(x.shape)}")
        out = [torch.zeros((0, self.model.num_classes), device=self.device)]
        out += [  # a chunk crosses to its slot's device at a time
            self.forward(x[s:e].to(dev).to(torch.float32), model) for model, dev, s, e in self.chunks(len(x))
        ]
        return self.gather_rows(out)

    def predict_proba(self, images) -> torch.Tensor:
        return torch.softmax(self.predict_logits(images), dim=-1)

    def predict(self, images) -> np.ndarray:
        idx = torch.argmax(self.predict_logits(images), dim=-1).cpu().numpy()
        return self.classes[idx]

    def score(self, images, y) -> float:
        return float(np.mean(self.predict(images) == np.asarray(y)))

    def save(self, path) -> None:
        """One ``torch.save`` file of tensors and plain values: the state
        dict (on the CPU), the classes as a list and the config's fields.
        Over a mesh that spans processes rank 0 writes, then every rank
        waits for it."""
        if self.mesh is not None and self.mesh.spans_processes:
            if self.mesh.rank == 0:
                self._write(path)
            barrier(self.mesh.group)
        else:
            self._write(path)

    def _write(self, path) -> None:
        torch.save(
            {
                "state_dict": {k: v.detach().cpu() for k, v in self.model.state_dict().items()},
                "classes": np.asarray(self.classes).tolist(),
                "config": dataclasses.asdict(self.config) if self.config is not None else None,
            },
            path,
        )

    @classmethod
    def load(cls, path, *, config: CNNConfig | None = None, device="cuda") -> "CNNHead":
        """A head saved by :meth:`save`, on ``device``. ``config`` (which
        tpumcia's ``load`` requires) is needed only where none was saved."""
        require_device(device, "CNNHead.load")
        saved = torch.load(path, map_location="cpu", weights_only=True)
        if config is None:
            if saved["config"] is None:
                raise ValueError(f"{path} holds no config; pass config=")
            config = CNNConfig(**saved["config"])
        state = saved["state_dict"]
        model = make_resnet(config.num_classes, in_channels=state["stem.weight"].shape[1],
                            width=config.width, depth=config.depth)
        model.load_state_dict(state)
        model = model.to(torch.device(device), memory_format=torch.channels_last)
        return cls(model=model, classes=np.asarray(saved["classes"]), config=config)


def epoch_batches(n: int, batch_size: int, epochs: int, seed: int):
    """tpumcia's epoch order: per epoch a (steps, batch) index array, the
    permutation of ``np.random.default_rng(seed)`` padded with its own first
    entries to whole batches (``batch`` is ``min(batch_size, n)``)."""
    bs = min(batch_size, n)
    steps = -(-n // bs)
    rng = np.random.default_rng(seed)
    for _ in range(epochs):
        order = rng.permutation(n)
        pad = steps * bs - n
        if pad:
            order = np.concatenate([order, order[:pad]])
        yield order.reshape(steps, bs)


def train_step(model: ResNet, optimizer, images: torch.Tensor, y_idx: torch.Tensor) -> torch.Tensor:
    """One AdamW step on the mean softmax cross-entropy of a batch; returns
    the loss (before the step) as a 0-d tensor on the device."""
    optimizer.zero_grad(set_to_none=True)
    loss = F.cross_entropy(model(images), y_idx)
    loss.backward()
    optimizer.step()
    return loss.detach()


def make_optimizer(model: ResNet, cfg: CNNConfig) -> torch.optim.Optimizer:
    """``optax.adamw(learning_rate, weight_decay=...)``: decoupled decay on
    every parameter, b1 0.9, b2 0.999, eps 1e-8 outside the square root."""
    return torch.optim.AdamW(
        model.parameters(), lr=cfg.learning_rate, betas=(0.9, 0.999), eps=1e-8,
        weight_decay=cfg.weight_decay,
    )


def fit_cnn(
    images,
    labels,
    *,
    device="cuda",
    config: CNNConfig | None = None,
    mesh=None,
    images_eval=None,
    labels_eval=None,
    verbose: bool = False,
) -> CNNHead:
    """Train the ResNet on (B, H, W, C) images in [0, 1] (float) or [0, 255]
    (integer, normalised on the device), numpy or a tensor, on ``device``,
    or over ``mesh`` (a ``parallel.Mesh``; ``device`` then gives way to its
    first local slot's device, and every rank passes the same full
    ``(images, labels)``)."""
    if mesh is None:
        require_device(device, "fit_cnn")
    if getattr(images, "ndim", np.ndim(images)) != 4:
        raise ValueError(
            f"fit_cnn expects (B, H, W, C) images; got shape "
            f"{tuple(np.shape(images))}"
        )
    labels = np.asarray(labels)
    if labels.shape != (images.shape[0],):
        raise ValueError(
            f"labels shape {labels.shape} does not match the "
            f"{images.shape[0]} images"
        )
    device = torch.device(device) if mesh is None else check_mesh(mesh).first_device
    classes, y_idx = np.unique(labels, return_inverse=True)
    cfg = config or CNNConfig(num_classes=len(classes))
    images_all = images_on_device(images, device)
    y_all = torch.from_numpy(y_idx.astype(np.int64)).to(device)

    model = make_resnet(cfg.num_classes, in_channels=images_all.shape[-1], width=cfg.width,
                        depth=cfg.depth)
    init_parameters(model, torch.Generator().manual_seed(cfg.seed))
    model = model.to(device, memory_format=torch.channels_last)
    optimizer = make_optimizer(model, cfg)
    if mesh is None:
        replicas = None

        def step(xb, yb):
            return train_step(model, optimizer, xb, yb)
    else:
        replicas = replicate(model, mesh)

        def step(xb, yb):
            return data_parallel_step(replicas, optimizer, mesh, xb, yb)

    def head(history=()):
        return CNNHead(model=model, classes=classes, config=cfg, history=list(history), mesh=mesh,
                       replicas=replicas)

    history: list = []
    # nothing reads the loss mid-training: every fetch waits for the device,
    # so without verbose or an eval set the epochs' means leave it once
    eager_history = verbose or images_eval is not None
    epoch_losses: list[torch.Tensor] = []
    n = images_all.shape[0]
    for epoch, idx_all in enumerate(epoch_batches(n, cfg.batch_size, cfg.epochs, cfg.seed)):
        idx_dev = torch.from_numpy(idx_all).to(device)
        losses = [step(images_all[idx], y_all[idx]) for idx in idx_dev]
        mean_loss = torch.stack(losses).mean()
        if eager_history:
            entry = {"epoch": epoch, "loss": float(mean_loss)}
            if images_eval is not None:
                entry["eval_acc"] = head().score(images_eval, labels_eval)
            history.append(entry)
            if verbose:
                print(entry)
        else:
            epoch_losses.append(mean_loss)
    if not eager_history and epoch_losses:
        means = torch.stack(epoch_losses).cpu().numpy()  # one fetch for all epochs
        history = [{"epoch": e, "loss": float(m)} for e, m in enumerate(means)]
    return head(history)

"""Classifier heads over the feature matrix (counterpart of
``tpumcia.models.heads``).

- :class:`LogisticHead`: multinomial logistic regression;
- :class:`MLPHead`: a dense -> ReLU stack with a linear readout;
- :class:`RandomForestHead`: the reference's forest (ipynb:404), fitted on
  the device by ``forest_fit`` with sklearn's semantics and scored by
  ``forest_device.DeviceForest``.

The logistic and MLP heads are fitted on the device with full-batch Adam on
softmax cross-entropy plus ``l2 * sum(w^2)`` over the weight matrices:
optax's ``adam`` (b1 0.9, b2 0.999, eps 1e-8) and ``torch.optim.Adam`` apply
the same update. Their initial weights come from a ``torch.Generator``
seeded with ``HeadConfig.seed``, the same distributions as the JAX
package's ``jax.random`` draws but not the same numbers. :func:`fit_head` is
the entry (scale, then fit). Their checkpoints are tpumcia's npz layout, so
either package loads the other's; the forest's is an npz of its tree arrays
(tpumcia pickles an sklearn object, which needs sklearn to load), and
``RandomForestHead.from_sklearn`` carries a fitted sklearn forest across.

On a CUDA device a fit of more than :data:`GRAPH_WARMUP_STEPS` steps runs
that many steps eagerly, captures one step as a CUDA graph and replays it
for the rest, so the card and not the host's launches pace the fit; on the
CPU, or with fewer steps, every step runs eagerly. The graph lives for one
fit: collections differ in size from call to call, and a pool kept between
calls would sit on top of the next extraction's peak.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import math
import warnings

import numpy as np
import torch
from torch import nn

from tpumcia_torch.config import HeadConfig
from tpumcia_torch.models.forest_device import DeviceForest
from tpumcia_torch.models.forest_fit import Tree, fit_forest
from tpumcia_torch.models.scaler import MinMaxScaler
from tpumcia_torch.utils.device import require_device
from tpumcia_torch.utils.profiling import COUNTERS, trace


def init_weights(num_features: int, num_classes: int, *, seed: int, device) -> torch.Tensor:
    """The logistic head's initial weights, ``0.01 * N(0, 1)`` from
    ``torch.Generator(device).manual_seed(seed)`` (the JAX package draws the
    same distribution from ``jax.random.key(seed)``)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return torch.randn(
        (num_features, num_classes), generator=gen, dtype=torch.float32, device=device
    ) * 0.01


def init_mlp_params(dims, *, seed: int, device) -> dict:
    """The MLP head's initial ``{"hidden": ({"w", "b"}, ...), "out": {"w",
    "b"}}`` for layer widths ``dims`` (input first): He-normal weights
    ``N(0, 1) * sqrt(2 / d_in)`` drawn layer by layer from one generator
    seeded with ``seed``, zero biases (tpumcia's init, drawn in torch)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    layers = [
        {
            "w": torch.randn((d_in, d_out), generator=gen, dtype=torch.float32, device=device)
            * math.sqrt(2.0 / d_in),
            "b": torch.zeros((d_out,), dtype=torch.float32, device=device),
        }
        for d_in, d_out in zip(dims[:-1], dims[1:])
    ]
    return {"hidden": tuple(layers[:-1]), "out": layers[-1]}


# torch.optim.Adam's settings, optax.adam's defaults
BETAS, EPS = (0.9, 0.999), 1e-8
# eager steps before the capture: the first step allocates the optimizer's
# state, the autograd buffers and the side stream's cuBLAS workspace, none
# of which the captured step may allocate
GRAPH_WARMUP_STEPS = 1


def _step_split(num_steps: int, device_type: str) -> tuple[int, int]:
    """(eager steps, graph replays) of a fit of ``num_steps`` steps on a
    ``device_type`` device: past the warm-up on ``cuda``, the warm-up
    eagerly and the rest by replay; otherwise every step eagerly."""
    if device_type == "cuda" and num_steps > GRAPH_WARMUP_STEPS:
        return GRAPH_WARMUP_STEPS, num_steps - GRAPH_WARMUP_STEPS
    return num_steps, 0


def _leaves(tensors: list[torch.Tensor]) -> list[torch.Tensor]:
    return [t.detach().clone().requires_grad_(True) for t in tensors]


def _steps(opt, params, loss_fn, num_steps: int) -> None:
    for _ in range(num_steps):
        opt.zero_grad(set_to_none=True)
        loss_fn(params).backward()
        opt.step()


def _eager_adam(tensors, loss_fn, *, num_steps: int, lr: float) -> list[torch.Tensor]:
    """``num_steps`` eager full-batch Adam steps (``torch.optim.Adam``'s
    default implementation) on copies of ``tensors``; returns the fitted
    copies, detached."""
    params = _leaves(tensors)
    _steps(torch.optim.Adam(params, lr=lr, betas=BETAS, eps=EPS), params, loss_fn, num_steps)
    return [p.detach() for p in params]


@functools.cache
def _side_stream(device: torch.device) -> torch.cuda.Stream:
    """The stream a device's fits are captured on (a capture cannot run on
    the default stream). One a device, so that the allocator's blocks freed
    on it serve the next fit; it holds no memory of its own. Fits on one
    device share it, so they run one at a time, as the port calls them."""
    return torch.cuda.Stream(device)


def _graphed_adam(tensors, loss_fn, *, warmup: int, replays: int, lr: float) -> list[torch.Tensor]:
    """``warmup`` eager steps, then one step captured as a CUDA graph and
    replayed ``replays`` times, with the fused capturable Adam (its step
    count on the card, its bias corrections in double as the eager loop's),
    on the side stream, which the caller's stream then waits for; returns
    the fitted copies of ``tensors``, detached. The graph goes when this
    returns, and its pool, with the grads in it, goes back to the allocator
    (which frees the pool's segment when it next runs short). A loss that
    synchronises fails the capture."""
    params = _leaves(tensors)
    opt = torch.optim.Adam(params, lr=lr, betas=BETAS, eps=EPS, fused=True, capturable=True)
    device = params[0].device
    caller = torch.cuda.current_stream(device)
    side = _side_stream(device)
    side.wait_stream(caller)
    with torch.cuda.stream(side):
        with warnings.catch_warnings():  # capturable steps run uncaptured on purpose
            warnings.filterwarnings("ignore", "This instance was constructed with capturable=True")
            _steps(opt, params, loss_fn, warmup)
        # the captured backward then writes fresh grads in the graph's pool,
        # which each replay overwrites, and does not accumulate into old ones
        opt.zero_grad(set_to_none=True)
        graph = torch.cuda.CUDAGraph()
        # not torch.cuda.graph(): it synchronises and empties the allocator's cache
        graph.capture_begin(capture_error_mode="thread_local")
        try:
            loss_fn(params).backward()
            opt.step()
        except Exception:
            with contextlib.suppress(RuntimeError):  # the capture is void: raise its cause
                graph.capture_end()
            raise
        graph.capture_end()
        for _ in range(replays):
            graph.replay()
    caller.wait_stream(side)
    # cuBLAS and cuBLASLt keep a workspace (32 MiB each on the H100)
    # allocated for every stream they have run on: the side stream's would
    # sit on top of the next extraction's peak. Dropped here, every stream's
    # goes back to the allocator's cache, each stream's to its own, and the
    # next matmul on a stream takes it back from there.
    torch._C._cuda_clearCublasWorkspaces()
    return [p.detach() for p in params]


def _adam(tensors: list[torch.Tensor], loss_fn, *, num_steps: int, lr: float) -> list[torch.Tensor]:
    """``num_steps`` full-batch Adam steps on copies of ``tensors``; returns
    the fitted copies, detached. ``loss_fn(params)`` must not synchronise.
    Split by :func:`_step_split`: on a CUDA device the warm-up's steps run
    eagerly and the rest replay one captured step (:func:`_graphed_adam`),
    captured anew every fit (no graph is kept between calls); elsewhere
    :func:`_eager_adam`. The fit is the ``adam`` span and adds its steps to
    ``COUNTERS["adam_steps"]``, the replayed ones to
    ``COUNTERS["adam_graph_steps"]``."""
    eager, replays = _step_split(num_steps, tensors[0].device.type)
    with trace("adam"), torch.enable_grad():
        if replays:
            fitted = _graphed_adam(tensors, loss_fn, warmup=eager, replays=replays, lr=lr)
        else:
            fitted = _eager_adam(tensors, loss_fn, num_steps=num_steps, lr=lr)
    COUNTERS["adam_steps"] += num_steps
    COUNTERS["adam_graph_steps"] += replays
    return fitted


def _softmax_ce(logits: torch.Tensor, y_onehot: torch.Tensor) -> torch.Tensor:
    return -(y_onehot * torch.log_softmax(logits, dim=-1)).sum(-1).mean()


def _fit_logistic(
    X: torch.Tensor, y_onehot: torch.Tensor, w0: torch.Tensor, b0: torch.Tensor,
    *, num_steps: int, lr: float, l2: float,
) -> dict[str, torch.Tensor]:
    """``num_steps`` full-batch Adam steps from (w0, b0); returns the fitted
    ``{"w": (F, k), "b": (k,)}``."""
    w, b = _adam([w0, b0], _logistic_loss(X, y_onehot, l2), num_steps=num_steps, lr=lr)
    return {"w": w, "b": b}


def _logistic_loss(X: torch.Tensor, y_onehot: torch.Tensor, l2: float):
    """The logistic head's loss of ``[w, b]``: softmax cross-entropy plus
    ``l2 * sum(w^2)``."""
    def loss(p):
        w, b = p
        return _softmax_ce(X @ w + b, y_onehot) + l2 * (w * w).sum()

    return loss


def logistic_predict_logits(params: dict[str, torch.Tensor], X: torch.Tensor) -> torch.Tensor:
    return X @ params["w"] + params["b"]


def mlp_predict_logits(params: dict, X: torch.Tensor) -> torch.Tensor:
    """Dense -> ReLU per hidden layer, then the linear readout."""
    h = X
    for layer in params["hidden"]:
        h = torch.relu(h @ layer["w"] + layer["b"])
    return h @ params["out"]["w"] + params["out"]["b"]


def _layers(params: dict) -> list[dict]:
    return [*params["hidden"], params["out"]]


def _fit_mlp(
    X: torch.Tensor, y_onehot: torch.Tensor, params0: dict,
    *, num_steps: int, lr: float, l2: float,
) -> dict:
    """``num_steps`` full-batch Adam steps from ``params0``; returns the
    fitted params in the same layout."""
    return _unflatten(_adam(_flatten(params0), _mlp_loss(X, y_onehot, l2),
                            num_steps=num_steps, lr=lr))


def _flatten(params: dict) -> list[torch.Tensor]:
    """The MLP's params as ``[w0, b0, w1, b1, ...]``, the readout last."""
    return [t for layer in _layers(params) for t in (layer["w"], layer["b"])]


def _unflatten(flat: list[torch.Tensor]) -> dict:
    layers = [{"w": flat[i], "b": flat[i + 1]} for i in range(0, len(flat), 2)]
    return {"hidden": tuple(layers[:-1]), "out": layers[-1]}


def _mlp_loss(X: torch.Tensor, y_onehot: torch.Tensor, l2: float):
    """The MLP head's loss of its params as :func:`_flatten` lists them:
    softmax cross-entropy plus ``l2`` times the weight matrices' squared sum."""
    def loss(flat):
        reg = sum((w * w).sum() for w in flat[0::2])
        return _softmax_ce(mlp_predict_logits(_unflatten(flat), X), y_onehot) + l2 * reg

    return loss


def _config_from_npz(z) -> HeadConfig:
    if "config_json" not in z:
        return HeadConfig()
    d = json.loads(str(z["config_json"]))
    if isinstance(d.get("hidden"), list):
        d["hidden"] = tuple(d["hidden"])
    return HeadConfig(**d)


class _Head(nn.Module):
    """What both heads share: MinMax scaling (optional) before ``forward``,
    the label classes, predictions and the npz payload's common part."""

    def __init__(self, classes, scaler: MinMaxScaler | None, config: HeadConfig, device):
        super().__init__()
        if scaler is not None:
            self.register_buffer("data_min", scaler.data_min.to(device))
            self.register_buffer("data_max", scaler.data_max.to(device))
        else:
            self.data_min = self.data_max = None
        self.classes = np.asarray(classes)
        self.config = config

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    @property
    def scaler(self) -> MinMaxScaler | None:
        if self.data_min is None:
            return None
        return MinMaxScaler(self.data_min, self.data_max)

    def _prep(self, X) -> torch.Tensor:
        X = torch.as_tensor(X, dtype=torch.float32, device=self.device)
        return self.scaler.transform(X) if self.data_min is not None else X

    def predict_logits(self, X) -> torch.Tensor:
        return self(X)

    def predict_proba(self, X) -> torch.Tensor:
        return torch.softmax(self(X), dim=-1)

    def predict(self, X) -> np.ndarray:
        return self.classes[torch.argmax(self(X), dim=-1).cpu().numpy()]

    def score(self, X, y) -> float:
        """Mean accuracy (sklearn's classifier ``score`` contract)."""
        return float(np.mean(self.predict(X) == np.asarray(y)))

    def _payload(self) -> dict:
        payload = {
            "classes": self.classes,
            "config_json": np.asarray(json.dumps(dataclasses.asdict(self.config))),
        }
        if self.data_min is not None:
            payload["scaler_min"] = self.data_min.cpu().numpy()
            payload["scaler_max"] = self.data_max.cpu().numpy()
        return payload

    @staticmethod
    def _scaler_from_npz(z, device) -> MinMaxScaler | None:
        if "scaler_min" not in z:
            return None
        return MinMaxScaler.from_stats(z["scaler_min"], z["scaler_max"], device=device)


def _tensor(x, device) -> torch.Tensor:
    return torch.tensor(np.asarray(x), dtype=torch.float32, device=device)


def _labels_onehot(y, device):
    classes, y_idx = np.unique(np.asarray(y), return_inverse=True)
    onehot = torch.nn.functional.one_hot(
        torch.as_tensor(y_idx, dtype=torch.int64, device=device), len(classes)
    ).to(torch.float32)
    return classes, onehot


class LogisticHead(_Head):
    """Fitted logistic head: MinMax scaling (optional) then ``X @ w + b``.
    ``classes`` maps the argmax index back to the user's labels."""

    def __init__(
        self, w: torch.Tensor, b: torch.Tensor, classes, *,
        scaler: MinMaxScaler | None = None, config: HeadConfig | None = None,
    ):
        super().__init__(classes, scaler, config or HeadConfig(), w.device)
        self.w = nn.Parameter(w, requires_grad=False)
        self.b = nn.Parameter(b, requires_grad=False)

    @classmethod
    def from_numpy(
        cls, params: dict, classes, dmin, dmax, *, config: HeadConfig | None = None,
        device="cuda",
    ) -> "LogisticHead":
        """Carry over a fitted tpumcia head: its ``{"w", "b"}`` and the
        scaler's per-feature min/max (``dmin``/``dmax`` None: no scaler)."""
        scaler = None if dmin is None else MinMaxScaler(_tensor(dmin, device), _tensor(dmax, device))
        return cls(_tensor(params["w"], device), _tensor(params["b"], device), classes,
                   scaler=scaler, config=config)

    @property
    def params(self) -> dict[str, torch.Tensor]:
        return {"w": self.w, "b": self.b}

    def forward(self, X) -> torch.Tensor:
        """Logits of (scaled) X."""
        return logistic_predict_logits(self.params, self._prep(X))

    def coefficient_importance(self) -> np.ndarray:
        """Normalised mean |weight| per feature, a linear-model analogue of
        the forest's MDI ranking (tpumcia's ``coefficient_importance``)."""
        w = np.abs(self.w.cpu().numpy()).mean(axis=1)
        s = w.sum()
        return w / s if s > 0 else w

    def save(self, path) -> None:
        """tpumcia's npz checkpoint: w, b, classes, config, scaler."""
        np.savez(path, w=self.w.cpu().numpy(), b=self.b.cpu().numpy(), **self._payload())

    @classmethod
    def load(cls, path, *, device="cuda") -> "LogisticHead":
        require_device(device, "LogisticHead.load")
        with np.load(path, allow_pickle=False) as z:
            return cls(_tensor(z["w"], device), _tensor(z["b"], device), z["classes"],
                       scaler=cls._scaler_from_npz(z, device), config=_config_from_npz(z))

    @classmethod
    def fit(
        cls, X: torch.Tensor, y, *, config: HeadConfig | None = None,
        scaler: MinMaxScaler | None = None,
    ) -> "LogisticHead":
        """Fit on ``X`` (an (N, F) f32 tensor, on the device the fit runs
        on) from :func:`init_weights` at ``config.seed``."""
        cfg = config or HeadConfig()
        classes, onehot = _labels_onehot(y, X.device)
        Xs = scaler.transform(X) if scaler is not None else X
        k = len(classes)
        params = _fit_logistic(
            Xs, onehot, init_weights(X.shape[1], k, seed=cfg.seed, device=X.device),
            torch.zeros((k,), dtype=torch.float32, device=X.device),
            num_steps=cfg.num_steps, lr=cfg.learning_rate, l2=cfg.l2,
        )
        return cls(params["w"], params["b"], classes, scaler=scaler, config=cfg)


class MLPHead(_Head):
    """Fitted MLP head: MinMax scaling (optional), ``len(config.hidden)``
    dense -> ReLU layers and a linear readout."""

    def __init__(
        self, params: dict, classes, *, scaler: MinMaxScaler | None = None,
        config: HeadConfig | None = None,
    ):
        layers = _layers(params)
        super().__init__(classes, scaler, config or HeadConfig(kind="mlp"), layers[0]["w"].device)
        self.weights = nn.ParameterList(nn.Parameter(l["w"], requires_grad=False) for l in layers)
        self.biases = nn.ParameterList(nn.Parameter(l["b"], requires_grad=False) for l in layers)

    @classmethod
    def from_numpy(
        cls, params: dict, classes, dmin, dmax, *, config: HeadConfig | None = None,
        device="cuda",
    ) -> "MLPHead":
        """Carry over a fitted tpumcia MLP head (its params pytree of
        arrays) and the scaler's per-feature min/max (None: no scaler)."""
        def layer(l):
            return {"w": _tensor(l["w"], device), "b": _tensor(l["b"], device)}

        scaler = None if dmin is None else MinMaxScaler(_tensor(dmin, device), _tensor(dmax, device))
        p = {"hidden": tuple(layer(l) for l in params["hidden"]), "out": layer(params["out"])}
        return cls(p, classes, scaler=scaler, config=config)

    @property
    def params(self) -> dict:
        layers = [{"w": w, "b": b} for w, b in zip(self.weights, self.biases)]
        return {"hidden": tuple(layers[:-1]), "out": layers[-1]}

    def forward(self, X) -> torch.Tensor:
        return mlp_predict_logits(self.params, self._prep(X))

    def save(self, path) -> None:
        """tpumcia's npz checkpoint: each layer's w and b, classes, config,
        scaler."""
        p = self.params
        payload = {"num_hidden": np.int64(len(p["hidden"])),
                   "out_w": p["out"]["w"].cpu().numpy(), "out_b": p["out"]["b"].cpu().numpy()}
        for i, layer in enumerate(p["hidden"]):
            payload[f"hidden{i}_w"] = layer["w"].cpu().numpy()
            payload[f"hidden{i}_b"] = layer["b"].cpu().numpy()
        np.savez(path, **payload, **self._payload())

    @classmethod
    def load(cls, path, *, device="cuda") -> "MLPHead":
        require_device(device, "MLPHead.load")
        with np.load(path, allow_pickle=False) as z:
            hidden = tuple(
                {"w": _tensor(z[f"hidden{i}_w"], device), "b": _tensor(z[f"hidden{i}_b"], device)}
                for i in range(int(z["num_hidden"]))
            )
            params = {"hidden": hidden,
                      "out": {"w": _tensor(z["out_w"], device), "b": _tensor(z["out_b"], device)}}
            return cls(params, z["classes"], scaler=cls._scaler_from_npz(z, device),
                       config=_config_from_npz(z))

    @classmethod
    def fit(
        cls, X: torch.Tensor, y, *, config: HeadConfig | None = None,
        scaler: MinMaxScaler | None = None,
    ) -> "MLPHead":
        """Fit on ``X`` (an (N, F) f32 tensor, on the device the fit runs
        on) from :func:`init_mlp_params` at ``config.seed``."""
        cfg = config or HeadConfig(kind="mlp")
        classes, onehot = _labels_onehot(y, X.device)
        Xs = scaler.transform(X) if scaler is not None else X
        params0 = init_mlp_params([X.shape[1], *cfg.hidden, len(classes)], seed=cfg.seed,
                                  device=X.device)
        params = _fit_mlp(Xs, onehot, params0, num_steps=cfg.num_steps,
                          lr=cfg.learning_rate, l2=cfg.l2)
        return cls(params, classes, scaler=scaler, config=cfg)


# the per-node arrays of a forest checkpoint, one concatenation over its trees
_TREE_FIELDS = ("children_left", "children_right", "feature", "threshold", "value", "impurity",
                "n_node_samples", "weighted_n_node_samples")


def forest_mdi(trees, num_features: int) -> np.ndarray:
    """sklearn's ``RandomForestClassifier.feature_importances_`` from tree
    arrays, in float64: per tree, ``w*imp - w_l*imp_l - w_r*imp_r`` of each
    internal node summed into its feature in node order, divided by the
    root's weight and normalised; then the mean over the trees with more than
    one node, normalised again (zeros when no tree split)."""
    per_tree = []
    for t in trees:
        if t.node_count <= 1:
            continue
        imp = np.zeros(num_features)
        internal = np.flatnonzero(t.children_left != -1)
        left, right = t.children_left[internal], t.children_right[internal]
        w, i = t.weighted_n_node_samples, t.impurity
        np.add.at(imp, t.feature[internal],
                  w[internal] * i[internal] - w[left] * i[left] - w[right] * i[right])
        imp /= w[0]
        total = np.sum(imp)
        if total > 0.0:
            imp /= total
        per_tree.append(imp)
    if not per_tree:
        return np.zeros(num_features)
    mean = np.mean(per_tree, axis=0, dtype=np.float64)
    return mean / np.sum(mean)


class RandomForestHead:
    """Fitted random-forest head (tpumcia's ``RandomForestHead``): its trees
    in sklearn's ``tree_`` layout (``forest_fit.Tree``) and the
    :class:`DeviceForest` that scores them on ``device`` after MinMax scaling
    (optional)."""

    def __init__(self, trees, classes, *, num_features: int, scaler: MinMaxScaler | None = None,
                 config: HeadConfig | None = None, device="cuda"):
        self.trees = list(trees)
        self.classes = np.asarray(classes)
        self.num_features = int(num_features)
        self.config = config or HeadConfig(kind="random_forest")
        if scaler is not None:
            scaler = MinMaxScaler(scaler.data_min.to(device), scaler.data_max.to(device))
        self.forest = DeviceForest.from_arrays(self.trees, self.classes, scaler, device=device)

    @property
    def device(self) -> torch.device:
        return self.forest.device

    @property
    def scaler(self) -> MinMaxScaler | None:
        return self.forest.scaler

    def to_device(self) -> DeviceForest:
        """The forest laid out for inference on the head's device."""
        return self.forest

    def predict_proba(self, X) -> torch.Tensor:
        return self.forest.predict_proba(X)

    def predict(self, X) -> np.ndarray:
        return self.forest.predict(X)

    def score(self, X, y) -> float:
        """Mean accuracy (sklearn's classifier ``score`` contract)."""
        return float(np.mean(self.predict(X) == np.asarray(y)))

    def mdi_importance(self) -> np.ndarray:
        """Mean-decrease-in-impurity importances (the reference's
        ``model.feature_importances_``, ipynb:434)."""
        return forest_mdi(self.trees, self.num_features)

    def save(self, path) -> None:
        """npz checkpoint: the trees' arrays concatenated (``node_count``
        per tree), classes, config, scaler."""
        payload = {k: np.concatenate([getattr(t, k) for t in self.trees]) for k in _TREE_FIELDS}
        payload["node_count"] = np.array([t.node_count for t in self.trees], np.int64)
        payload["max_depth"] = np.array([t.max_depth for t in self.trees], np.int64)
        payload["num_features"] = np.int64(self.num_features)
        payload["classes"] = self.classes
        payload["config_json"] = np.asarray(json.dumps(dataclasses.asdict(self.config)))
        if self.scaler is not None:
            payload["scaler_min"] = self.scaler.data_min.cpu().numpy()
            payload["scaler_max"] = self.scaler.data_max.cpu().numpy()
        np.savez(path, **payload)

    @classmethod
    def load(cls, path, *, device="cuda") -> "RandomForestHead":
        require_device(device, "RandomForestHead.load")
        with np.load(path, allow_pickle=False) as z:
            bounds = np.cumsum(z["node_count"])[:-1]
            fields = {k: np.split(z[k], bounds) for k in _TREE_FIELDS}
            trees = [Tree(**{k: v[t] for k, v in fields.items()}, max_depth=int(d))
                     for t, d in enumerate(z["max_depth"])]
            return cls(trees, z["classes"], num_features=int(z["num_features"]),
                       scaler=_Head._scaler_from_npz(z, device), config=_config_from_npz(z),
                       device=device)

    @classmethod
    def from_sklearn(cls, model, *, scaler: MinMaxScaler | None = None,
                     config: HeadConfig | None = None, device="cuda") -> "RandomForestHead":
        """Carry over a fitted sklearn ``RandomForestClassifier`` (e.g. a
        tpumcia head's ``.model``; its ``estimators_[i].tree_`` read by duck
        typing, sklearn not imported) and the scaler it was fitted behind."""
        require_device(device, "RandomForestHead.from_sklearn")
        trees = [Tree.from_tree_(est.tree_) for est in model.estimators_]
        return cls(trees, model.classes_, num_features=model.n_features_in_, scaler=scaler,
                   config=config, device=device)

    @classmethod
    def fit(cls, X: torch.Tensor, y, *, config: HeadConfig | None = None,
            scaler: MinMaxScaler | None = None) -> "RandomForestHead":
        """Fit ``config.n_estimators`` trees of at most ``config.max_depth``
        levels on ``X`` (an (N, F) f32 tensor, on the device the fit runs
        on), with bootstraps and feature orders drawn from ``config.seed``."""
        cfg = config or HeadConfig(kind="random_forest")
        classes, y_idx = np.unique(np.asarray(y), return_inverse=True)
        Xs = scaler.transform(X) if scaler is not None else X
        trees = fit_forest(Xs, torch.from_numpy(y_idx), len(classes),
                           n_estimators=cfg.n_estimators, max_depth=cfg.max_depth, seed=cfg.seed)
        return cls(trees, classes, num_features=X.shape[1], scaler=scaler, config=cfg,
                   device=X.device)


def fit_head(
    features,
    labels,
    *,
    device="cuda",
    config: HeadConfig | None = None,
    scale: bool = True,
    scaler: MinMaxScaler | None = None,
):
    """MinMax-scale (fitted on the given rows) and fit the configured head on
    ``device`` (tpumcia's ``fit_head``). ``features``: a FeatureMatrix, an
    (N, F) array or a tensor. A prefit ``scaler`` overrides the fit."""
    device = torch.device(require_device(device, "fit_head"))
    cfg = config or HeadConfig()
    X = features if isinstance(features, torch.Tensor) else getattr(features, "values", features)
    if isinstance(X, torch.Tensor):
        X = X.to(device=device, dtype=torch.float32)
    else:
        X = torch.from_numpy(np.asarray(X, dtype=np.float32)).to(device)
    labels_arr = np.asarray(labels)
    if len(labels_arr) != len(X):
        raise ValueError(f"fit_head: {len(X)} feature rows but {len(labels_arr)} labels")
    if len(np.unique(labels_arr)) < 2:
        raise ValueError(
            "fit_head needs >= 2 distinct classes; got "
            f"{np.unique(labels_arr)!r} (a grouped/stratified split that "
            "left one class empty?)"
        )
    heads = {"logistic": LogisticHead, "mlp": MLPHead, "random_forest": RandomForestHead}
    if cfg.kind not in heads:
        raise ValueError(f"unknown head kind {cfg.kind!r}")
    if scaler is None and scale:
        scaler = MinMaxScaler.fit(X)
    return heads[cfg.kind].fit(X, labels_arr, config=cfg, scaler=scaler)

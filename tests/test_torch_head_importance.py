"""tpumcia_torch's scaler, logistic head, permutation sweeps and fused
fit + sweeps against the JAX package, on the same inputs.

JAX's draws (head init, sweep permutations) are replayed with jax and
handed to the port. Tolerances:
- logistic params after the same Adam steps from the same w0: 1e-4 abs
  (f32 matmuls and Adam updates rounded in another order);
- sweep baseline and drops: at most 1/N_test per entry, from f32 argmax
  near-ties (one test row flipping its predicted class);
- MinMax statistics: exact (min and max of the same f32 values).

The split of a fit's Adam steps between eager steps and CUDA graph replays
is checked here as arithmetic; the replays themselves only on the card
(``tests/test_torch_cuda.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.tree_util import Partial

from torch_parity import jax_init_weights, jax_permutations
from tpumcia.importance import channels as jchannels
from tpumcia.importance import permutation as jperm
from tpumcia.models import fused as jfused
from tpumcia.models import heads as jheads
from tpumcia_torch.importance import channels
from tpumcia_torch.importance import permutation as perm
from tpumcia_torch.models import fused, heads
from tpumcia_torch.models.heads import LogisticHead, _fit_logistic
from tpumcia_torch.models.scaler import MinMaxScaler

PARAM_ATOL = 1e-4


def _problem(n=120, f=9, k=3, seed=0):
    """Separable-ish f32 features with a dead (constant) column."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, k, size=n)
    X = rng.normal(size=(n, f)).astype(np.float32)
    X[:, 0] += 2.0 * y
    X[:, 1] -= 1.5 * y
    X[:, 2] = 3.0  # zero range
    return X, y.astype(np.int32)


def test_fit_logistic_matches_optax_adam():
    X, y = _problem()
    k = 3
    w0 = jax_init_weights(0, X.shape[1], k)
    onehot = np.eye(k, dtype=np.float32)[y]
    want = jheads._fit_logistic(
        jnp.asarray(X), jnp.asarray(onehot), jnp.asarray(w0), jnp.zeros((k,), jnp.float32),
        num_steps=60, lr=0.05, l2=1e-4,
    )
    got = _fit_logistic(
        torch.from_numpy(X), torch.from_numpy(onehot), torch.from_numpy(w0),
        torch.zeros(k), num_steps=60, lr=0.05, l2=1e-4,
    )
    np.testing.assert_allclose(got["w"].numpy(), np.asarray(want["w"]), rtol=0, atol=PARAM_ATOL)
    np.testing.assert_allclose(got["b"].numpy(), np.asarray(want["b"]), rtol=0, atol=PARAM_ATOL)


W = heads.GRAPH_WARMUP_STEPS


@pytest.mark.parametrize("device_type", ["cpu", "cuda"])
@pytest.mark.parametrize("num_steps", sorted({0, 1, W, W + 1, 500}))
def test_adam_step_split(num_steps, device_type):
    """(eager steps, graph replays): every step eager on the CPU and on the
    card up to the warm-up; past it, the warm-up eager and the rest
    replayed. Pure arithmetic, no device work."""
    eager, replays = heads._step_split(num_steps, device_type)
    assert eager + replays == num_steps
    if device_type == "cuda" and num_steps > W:
        assert (eager, replays) == (W, num_steps - W)
    else:
        assert (eager, replays) == (num_steps, 0)


def test_minmax_scaler_zero_range_rule():
    X, _ = _problem()
    X[3, 4] = np.nan
    s = MinMaxScaler.fit(torch.from_numpy(X))
    assert s.scale[2].item() == 1.0  # zero range -> scale 1 (sklearn)
    assert np.isfinite(s.data_min.numpy()).all()  # NaN ignored
    Xc = np.nan_to_num(X)
    out = MinMaxScaler.fit(torch.from_numpy(Xc)).transform(torch.from_numpy(Xc)).numpy()
    want = (Xc - Xc.min(0)) * np.where(np.ptp(Xc, 0) != 0, 1 / np.where(np.ptp(Xc, 0) != 0, np.ptp(Xc, 0), 1), 1)
    np.testing.assert_allclose(out, want, rtol=1e-6, atol=1e-6)


def test_perm_sweep_matches_jax_with_injected_permutations():
    X, y = _problem(n=90, seed=1)
    n, f = X.shape
    k, R, seed = 3, 4, 42
    rng = np.random.default_rng(2)
    params = {"w": rng.normal(size=(f, k)).astype(np.float32),
              "b": rng.normal(size=k).astype(np.float32)}
    dmin, dscale = X.min(0), np.ones(f, np.float32) / 3
    groups = [[0, 1, 2], [3, 4, 5], [6, 7, 8]]
    masks = perm.group_masks(groups, f)
    np.testing.assert_array_equal(masks, jperm.group_masks(groups, f))

    jp = {kk: jnp.asarray(v) for kk, v in params.items()}
    apply_j = Partial(jperm._scaled_logistic_apply, jp, jnp.asarray(dmin), jnp.asarray(dscale))
    base_j, drops_j = jperm._perm_sweep(
        jnp.asarray(X), jnp.asarray(y), jnp.asarray(masks), jax.random.key(seed), apply_j,
        n_repeats=R,
    )
    perms = torch.from_numpy(jax_permutations(seed, len(groups) * R, n)).long()
    tp = {kk: torch.from_numpy(v) for kk, v in params.items()}
    base_t, drops_t = perm._perm_sweep(
        torch.from_numpy(X), torch.from_numpy(y).long(), torch.from_numpy(masks),
        perms.reshape(len(groups), R, n),
        lambda Z: perm._scaled_logistic_apply(tp, torch.from_numpy(dmin), torch.from_numpy(dscale), Z),
    )
    tol = 1.0 / n + 1e-6
    assert abs(base_t.item() - float(base_j)) <= tol
    np.testing.assert_allclose(drops_t.numpy(), np.asarray(drops_j), rtol=0, atol=tol)


def test_draw_permutations_are_permutations():
    p = perm.draw_permutations(7, 50, seed=3, device="cpu")
    assert p.shape == (7, 50)
    assert torch.equal(p.sort(dim=1).values, torch.arange(50).expand(7, 50))
    assert torch.equal(p, perm.draw_permutations(7, 50, seed=3, device="cpu"))


def test_fused_fit_sweeps_matches_jax(monkeypatch):
    """The whole fused program with JAX's w0 and permutations injected."""
    X, y = _problem(n=160, seed=4)
    n, f = X.shape
    rng = np.random.default_rng(5)
    order = rng.permutation(n)
    tr, te = np.sort(order[40:]), np.sort(order[:40])
    groups = [[0, 1, 2], [3, 4, 5], [6, 7, 8]]
    names = [f"x{i}_Ch{g + 1}" for g, cols in enumerate(groups) for i in cols]
    R, hseed, iseed, k = 3, 0, 42, 3
    from tpumcia.config import HeadConfig as JHeadConfig
    from tpumcia.config import ImportanceConfig as JImportanceConfig
    from tpumcia_torch.config import HeadConfig, ImportanceConfig

    want = jfused.fit_logistic_with_importance(
        jnp.asarray(X), y, train_idx=tr, test_idx=te, groups=groups, names=names,
        head_config=JHeadConfig(num_steps=60, seed=hseed),
        importance_config=JImportanceConfig(n_repeats=R, seed=iseed),
    )
    monkeypatch.setattr(
        fused, "draw_permutations",
        lambda num_draws, n_te, *, seed, device: torch.from_numpy(
            jax_permutations(seed, num_draws, n_te)).long(),
    )
    got = fused.fit_logistic_with_importance(
        torch.from_numpy(X), y, train_idx=tr, test_idx=te, groups=groups, names=names,
        head_config=HeadConfig(num_steps=60, seed=hseed),
        importance_config=ImportanceConfig(n_repeats=R, seed=iseed),
        w0=torch.from_numpy(jax_init_weights(hseed, f, k)),
    )
    tol = 1.0 / len(te) + 1e-6
    assert abs(got.baseline_score - want.baseline_score) <= tol
    for a, b in [(got.channel_result, want.channel_result),
                 (got.feature_result, want.feature_result)]:
        np.testing.assert_allclose(
            a.extras["permutation"].importances, b.extras["permutation"].importances,
            rtol=0, atol=tol,
        )
    assert got.channel_result.ranking.tolist() == want.channel_result.ranking.tolist()
    assert np.mean(got.y_pred != want.y_pred) <= tol
    np.testing.assert_array_equal(got.head.data_min.numpy(), np.asarray(want.head.scaler.data_min))
    np.testing.assert_array_equal(got.head.data_max.numpy(), np.asarray(want.head.scaler.data_max))
    np.testing.assert_allclose(
        got.head.w.numpy(), np.asarray(want.head.params["w"]), rtol=0, atol=PARAM_ATOL
    )


def test_head_from_numpy_predicts_like_jax_head():
    X, y = _problem(seed=6)
    jhead = jheads.LogisticHead.fit(
        X, y, config=jheads.HeadConfig(num_steps=40),
        scaler=jheads.MinMaxScaler.fit(X),
    )
    head = LogisticHead.from_numpy(
        {kk: np.asarray(v) for kk, v in jhead.params.items()}, jhead.classes,
        np.asarray(jhead.scaler.data_min), np.asarray(jhead.scaler.data_max), device="cpu",
    )
    assert isinstance(head, torch.nn.Module)
    np.testing.assert_allclose(
        head(X).numpy(), np.asarray(jhead.predict_logits(X)), rtol=1e-5, atol=1e-5
    )
    assert np.mean(head.predict(X) != jhead.predict(X)) <= 1.0 / len(X)
    assert head.score(X, y) == pytest.approx(jhead.score(X, y), abs=1.0 / len(X))


@pytest.mark.parametrize("match,threshold", [("exact", 0.01), ("substring", None)])
def test_aggregate_channel_importance_is_a_copy(match, threshold):
    rng = np.random.default_rng(8)
    names = [f"f{i}_Ch{c}" for c in (1, 2, 3) for i in range(4)]
    imp = rng.normal(0.02, 0.03, size=len(names))
    a = channels.aggregate_channel_importance(imp, names, 3, threshold=threshold, match=match)
    b = jchannels.aggregate_channel_importance(imp, names, 3, threshold=threshold, match=match)
    np.testing.assert_array_equal(a.total, b.total)
    np.testing.assert_array_equal(a.ranking, b.ranking)
    assert a.summary() == b.summary()


def test_labels_to_class_idx_sentinel():
    out = perm.labels_to_class_idx(np.array([3, 1, 9]), np.array([1, 3]))
    np.testing.assert_array_equal(out, jperm.labels_to_class_idx(np.array([3, 1, 9]), np.array([1, 3])))
    with pytest.raises(ValueError, match="n_repeats"):
        perm.check_n_repeats(0)

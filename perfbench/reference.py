"""The plain reference that decides ``correct``: the whole analysis of a cell
worked out again from the inputs the benchmark made, in float64 PyTorch,
block by block, with no kernel, cache or batching of the program.

It imports neither the program nor ``jax`` and takes nothing the program
made: the noise channels, the split, the scaler, the head's initial weights
and the sweeps' permutations are derived again from the seeds the
configuration states, by the rules the configuration states.

- the features: per (object, channel), the 17 intensity statistics of the
  selected pixels (levels / (L - 1); percentiles at q = 0.1 .. 0.9 as
  ``np.percentile`` gives them, biased Fisher kurtosis and skew, base-2
  entropy) and the 6 GLCM properties of ``skimage.feature.graycoprops``
  after the reference notebook's rescale ``trunc((v / top) / (vmax / top)
  * top)``, over the pixel pairs at the offset whose both pixels are
  selected;
- the head: MinMax scaling fitted on the train rows, then full-batch Adam
  (b1 0.9, b2 0.999, eps 1e-8) on softmax cross-entropy plus ``l2 *
  sum(w^2)`` from ``0.01 * N(0, 1)`` weights and zero biases;
- both permutation sweeps: the mean accuracy drop over ``n_repeats``
  permutations of the test rows, each channel's columns jointly and each
  column alone.

``control`` computes the same below what the configurations state (a
float64 feature matrix from exact statistics; the head and sweeps in
float32 with TF32 off): ``"bf16"`` rounds the feature matrix to bfloat16
and runs the head and sweeps in float32 with TF32 matrix products, and has
to come out as not correct; ``"tf32_head"`` keeps the float64 matrix and
takes only the head's step down, to TF32.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

QS = (0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9)  # the notebook's percentile q (in %)
INTENSITY = 17
GLCM = 6
BLOCK = 256  # objects a block


# ---- the inputs the program derives ---------------------------------------

def synth_batch_seed(seed: int, batch: int) -> int:
    """The seed of batch ``batch``'s noise stream: numpy's SeedSequence of
    (seed, batch)."""
    return int(np.random.SeedSequence([seed, batch]).generate_state(1, np.uint64)[0])


def noise_stack(gray: torch.Tensor, *, num_noise: int, var: float, seed: int,
                batch: int) -> torch.Tensor:
    """(n, H, W) levels -> (n, 1 + num_noise, H, W) int32: the gray image and
    ``num_noise`` channels ``trunc(clip(z * sqrt(f32 var), 0, 1) * 255)`` in
    float32, with z drawn batch by batch as (batch, num_noise, H, W)
    standard normals from a generator on the images' device seeded with
    :func:`synth_batch_seed`; the last batch is drawn at its full size, its
    rows past the end of the collection dropped."""
    n, H, W = gray.shape
    batch = min(batch, n)
    scale = torch.sqrt(torch.tensor(var, dtype=torch.float32, device=gray.device))
    out = torch.empty((n, 1 + num_noise, H, W), dtype=torch.int32, device=gray.device)
    for i in range(math.ceil(n / batch)):
        lo, hi = i * batch, min((i + 1) * batch, n)
        gen = torch.Generator(device=gray.device)
        gen.manual_seed(synth_batch_seed(seed, i))
        z = torch.randn((batch, num_noise, H, W), generator=gen, dtype=torch.float32,
                        device=gray.device)[: hi - lo]
        out[lo:hi, 0] = gray[lo:hi].to(torch.int32)
        out[lo:hi, 1:] = (torch.clamp(z * scale, 0.0, 1.0) * 255.0).to(torch.int32)
    return out


def split(n: int, *, test_size: float, seed: int, stratify=None, groups=None):
    """(train rows, test rows), sorted: whole groups shuffled into the test
    side until it holds ``test_size`` of the rows; or per class the first
    ``round(test_size * size)`` rows of a shuffle (at least one, and one
    left for training); or the first ``round(test_size * n)`` of a shuffle."""
    rng = np.random.default_rng(seed)
    if groups is not None:
        groups = np.asarray(groups)
        uniq = rng.permutation(np.unique(groups))
        chosen, count = [], 0
        for g in uniq:
            if count >= test_size * n:
                break
            chosen.append(g)
            count += int((groups == g).sum())
        if count == n:
            chosen = chosen[:-1]
        test = np.isin(groups, chosen)
        return np.flatnonzero(~test), np.flatnonzero(test)
    if stratify is not None:
        stratify = np.asarray(stratify)
        tr, te = [], []
        for c in np.unique(stratify):
            rows = rng.permutation(np.flatnonzero(stratify == c))
            k = min(max(1, int(round(test_size * len(rows)))), len(rows) - 1)
            te.append(rows[:k])
            tr.append(rows[k:])
        return np.sort(np.concatenate(tr)), np.sort(np.concatenate(te))
    rows = rng.permutation(n)
    k = min(max(int(round(test_size * n)), 1), n - 1)
    return np.sort(rows[k:]), np.sort(rows[:k])


# ---- the features -----------------------------------------------------------

def _row_sums(values: torch.Tensor, rows: torch.Tensor, n_rows: int) -> torch.Tensor:
    return torch.zeros(n_rows, dtype=values.dtype, device=values.device).index_add_(0, rows, values)


def _intensity(x: torch.Tensor, sel: torch.Tensor, L: int) -> torch.Tensor:
    """(R, P) levels and selection -> (R, 17) float64."""
    R, P = x.shape
    f64 = torch.float64
    top = float(L - 1)
    n = sel.sum(1)
    empty = n == 0
    safe_n = n.clamp(min=1).to(f64)
    lo_lev = torch.where(sel, x, L).amin(1)
    hi_lev = torch.where(sel, x, -1).amax(1)
    srt = torch.where(sel, x, L).sort(1).values
    pos = torch.tensor(QS, dtype=f64, device=x.device)[None] / 100.0 * (safe_n[:, None] - 1)
    k_lo, k_hi = pos.floor().long(), pos.ceil().long()
    v_lo = srt.gather(1, k_lo).to(f64)
    v_hi = srt.gather(1, k_hi).to(f64)
    pct = (v_lo + (pos - k_lo) * (v_hi - v_lo)) / top
    v = x.to(f64) / top
    w = sel.to(f64)
    total = (v * w).sum(1)
    mean = total / safe_n
    d = (v - mean[:, None]) * w
    d2 = d * d
    m2 = d2.sum(1) / safe_n
    m3 = (d2 * d).sum(1) / safe_n
    m4 = (d2 * d2).sum(1) / safe_n
    flat = lo_lev == hi_lev
    nan = torch.full_like(m2, float("nan"))
    kurt = torch.where(flat, nan, m4 / torch.where(flat, 1.0, m2) ** 2 - 3.0)
    skew = torch.where(flat, nan, m3 / torch.where(flat, 1.0, m2) ** 1.5)
    rows = torch.arange(R, device=x.device)[:, None].expand(R, P)
    counts = torch.bincount((rows * L + x)[sel], minlength=R * L).view(R, L).to(f64)
    p = counts / safe_n[:, None]
    entropy = -torch.where(p > 0, p * torch.log2(torch.where(p > 0, p, 1.0)), 0.0).sum(1)
    cols = [lo_lev.to(f64) / top, *pct.unbind(1), hi_lev.to(f64) / top, total, mean,
            m2.sqrt(), kurt, skew, entropy]
    out = torch.stack(cols, 1)
    return torch.where(empty[:, None], 0.0, out)


def _glcm(x: torch.Tensor, sel: torch.Tensor, L: int, H: int, W: int, offset) -> torch.Tensor:
    """(R, H*W) levels and selection -> (R, 6) float64 [contrast,
    dissimilarity, homogeneity, ASM, energy, correlation]."""
    R = x.shape[0]
    f64 = torch.float64
    top_t = torch.tensor(float(L - 1), dtype=f64, device=x.device)
    vmax = torch.where(sel, x, -1).amax(1).clamp(min=0)
    scaled = ((x.to(f64) / top_t) / (vmax.to(f64) / top_t)[:, None]) * float(L - 1)
    scaled = torch.nan_to_num(scaled, nan=0.0, posinf=float(L - 1)).clamp(0.0, float(L - 1))
    resc = torch.where((vmax > 0)[:, None], scaled.to(torch.int64), 0).view(R, H, W)
    s = sel.view(R, H, W)
    dr, dc = offset
    r0, r1, c0, c1 = max(0, -dr), H - max(0, dr), max(0, -dc), W - max(0, dc)
    i = resc[:, r0:r1, c0:c1]
    j = resc[:, r0 + dr:r1 + dr, c0 + dc:c1 + dc]
    pair = s[:, r0:r1, c0:c1] & s[:, r0 + dr:r1 + dr, c0 + dc:c1 + dc]
    rows = torch.arange(R, device=x.device)[:, None, None].expand_as(pair)[pair]
    i, j = i[pair], j[pair]
    n = _row_sums(torch.ones_like(rows, dtype=f64), rows, R)
    safe_n = n.clamp(min=1)
    fi, fj = i.to(f64), j.to(f64)
    d = fi - fj
    contrast = _row_sums(d * d, rows, R) / safe_n
    dissim = _row_sums(d.abs(), rows, R) / safe_n
    homog = _row_sums(1.0 / (1.0 + d * d), rows, R) / safe_n
    keys, counts = torch.unique((rows * L + i) * L + j, return_counts=True)
    asm = _row_sums(counts.to(f64) ** 2, keys // (L * L), R) / (safe_n * safe_n)
    mu_i = _row_sums(fi, rows, R) / safe_n
    mu_j = _row_sums(fj, rows, R) / safe_n
    di, dj = fi - mu_i[rows], fj - mu_j[rows]
    var_i = _row_sums(di * di, rows, R) / safe_n
    var_j = _row_sums(dj * dj, rows, R) / safe_n
    cov = _row_sums(di * dj, rows, R) / safe_n
    sd_i, sd_j = var_i.sqrt(), var_j.sqrt()
    ok = (sd_i > 1e-15) & (sd_j > 1e-15)
    corr = torch.where(ok, cov / torch.where(ok, sd_i * sd_j, 1.0), 1.0)
    return torch.stack([contrast, dissim, homog, asm, asm.sqrt(), corr], 1)


def features(levels: torch.Tensor, mask, *, levels_n: int, offset, block: int = BLOCK) -> torch.Tensor:
    """(n, C, H, W) integer levels and an optional bool mask, (n, H, W)
    shared by the channels or (n, H, W, C) one each -> (n, 23 * C) float64
    on their device: the 17 intensity features of each channel in turn, then
    the 6 GLCM features of each channel in turn."""
    n, C, H, W = levels.shape
    out = torch.empty((n, C * (INTENSITY + GLCM)), dtype=torch.float64, device=levels.device)
    for s in range(0, n, block):
        e = min(s + block, n)
        x = levels[s:e].to(torch.int64).reshape((e - s) * C, H * W)
        if mask is None:
            sel = torch.ones_like(x, dtype=torch.bool)
        elif mask.dim() == 4:
            sel = mask[s:e].permute(0, 3, 1, 2).reshape((e - s) * C, H * W)
        else:
            sel = mask[s:e, None].expand(e - s, C, H, W).reshape((e - s) * C, H * W)
        out[s:e, : C * INTENSITY] = _intensity(x, sel, levels_n).view(e - s, C * INTENSITY)
        out[s:e, C * INTENSITY:] = _glcm(x, sel, levels_n, H, W, offset).view(e - s, C * GLCM)
    return out


def channel_columns(C: int) -> list[list[int]]:
    """Each channel's 23 columns in the layout :func:`features` returns."""
    return [[*range(c * INTENSITY, (c + 1) * INTENSITY),
             *range(C * INTENSITY + c * GLCM, C * INTENSITY + (c + 1) * GLCM)] for c in range(C)]


# ---- the head and the sweeps ------------------------------------------------

def _permutations(draws: int, n: int, seed: int, device) -> torch.Tensor:
    """(draws, n) row permutations: the argsort of float64 uniforms from a
    generator on ``device`` seeded with ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return torch.argsort(torch.rand((draws, n), generator=gen, dtype=torch.float64, device=device), dim=1)


@contextlib.contextmanager
def _tf32(on: bool):
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def head_and_sweeps(X: torch.Tensor, labels, train_idx, test_idx, *, num_channels: int,
                    head: dict, importance: dict, low: bool = False) -> dict:
    """Fit the head on the train rows of ``X`` (float64) and score the test
    rows and both sweeps, in float32 with TF32 matrix products where ``low``.
    Returns the test rows' class probabilities, the channels' and the
    columns' mean accuracy drops (numpy float64)."""
    dev = X.device
    dt = torch.float32 if low else torch.float64
    X = torch.nan_to_num(X).to(dt)
    labels = np.asarray(labels)
    classes, y_tr = np.unique(labels[train_idx], return_inverse=True)
    index = {c: i for i, c in enumerate(classes.tolist())}
    y_te = torch.as_tensor([index.get(v, -1) for v in labels[test_idx].tolist()], device=dev)
    k, F = len(classes), X.shape[1]
    tr = torch.as_tensor(train_idx, device=dev)
    te = torch.as_tensor(test_idx, device=dev)
    lo, hi = X[tr].amin(0), X[tr].amax(0)
    span = hi - lo
    scale = torch.where(span != 0, 1.0 / torch.where(span != 0, span, 1.0), 1.0)
    Xtr, Xte = (X[tr] - lo) * scale, (X[te] - lo) * scale
    Y = torch.nn.functional.one_hot(torch.as_tensor(y_tr, device=dev), k).to(dt)
    gen = torch.Generator(device=dev)
    gen.manual_seed(head["seed"])
    w = (torch.randn((F, k), generator=gen, dtype=torch.float32, device=dev) * 0.01).to(dt)
    b = torch.zeros(k, dtype=dt, device=dev)
    lr, l2, b1, b2, eps = head["learning_rate"], head["l2"], 0.9, 0.999, 1e-8
    m = [torch.zeros_like(w), torch.zeros_like(b)]
    v = [torch.zeros_like(w), torch.zeros_like(b)]
    with _tf32(low):
        for t in range(1, head["num_steps"] + 1):
            dz = (torch.softmax(Xtr @ w + b, dim=1) - Y) / len(train_idx)
            grads = (Xtr.T @ dz + 2.0 * l2 * w, dz.sum(0))
            for p, g, mi, vi in zip((w, b), grads, m, v):
                mi.mul_(b1).add_(g, alpha=1 - b1)
                vi.mul_(b2).addcmul_(g, g, value=1 - b2)
                denom = vi.sqrt() / math.sqrt(1 - b2 ** t) + eps
                p.addcdiv_(mi, denom, value=-lr / (1 - b1 ** t))
        base = Xte @ w + b

        def drops(cols_of_draw, perms):
            """Mean accuracy drop over the repeats of each group of columns."""
            out = []
            for cols, p in zip(cols_of_draw, perms):
                sub = Xte[:, cols]
                delta = (sub[p] - sub[None]) @ w[cols]
                acc = (torch.argmax(base[None] + delta, dim=-1) == y_te).to(torch.float64).mean(1)
                out.append(acc)
            acc = torch.stack(out)  # (G, R)
            base_acc = (torch.argmax(base, dim=-1) == y_te).to(torch.float64).mean()
            return (base_acc - acc).mean(1)

        R, n_te = importance["n_repeats"], len(test_idx)
        groups = channel_columns(num_channels)
        perms_g = _permutations(len(groups) * R, n_te, importance["seed"], dev).view(len(groups), R, n_te)
        perms_f = _permutations(F * R, n_te, importance["seed"], dev).view(F, R, n_te)
        channel = drops(groups, perms_g)
        column = drops([[f] for f in range(F)], perms_f)
    return {"proba": torch.softmax(base.to(torch.float64), dim=1).cpu().numpy(),
            "channel": channel.cpu().numpy(), "column": column.cpu().numpy(), "repeats": R}


def analyze(levels: torch.Tensor, mask, labels, groups, *, pipeline: dict, control=None) -> dict:
    """The whole analysis of one collection. ``levels``: (n, C, H, W) on the
    device; ``pipeline``: the configuration's settings (``levels``,
    ``offset``, ``split``, ``head``, ``importance``); ``control``: None,
    ``"bf16"`` or ``"tf32_head"`` (the module's docstring). Returns the float64
    feature matrix (numpy), the split and :func:`head_and_sweeps`' results."""
    n, C = levels.shape[:2]
    X = features(levels, mask, levels_n=pipeline["levels"], offset=pipeline["offset"])
    if control not in (None, "bf16", "tf32_head"):
        raise ValueError(f"no control {control!r}")
    if control == "bf16":
        X = X.to(torch.bfloat16).to(torch.float64)
    sp = pipeline["split"]
    tr, te = split(n, test_size=sp["test_size"], seed=sp["seed"],
                   stratify=labels if sp.get("stratify") else None,
                   groups=groups if sp.get("group_by") else None)
    out = head_and_sweeps(X, labels, tr, te, num_channels=C, head=pipeline["head"],
                          importance=pipeline["importance"], low=control is not None)
    out.update(features=X.cpu().numpy(), train_idx=tr, test_idx=te)
    return out

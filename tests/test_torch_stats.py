"""tpumcia_torch's GLCM sufficient statistics against the JAX package.

On the CPU the wrapper runs its plain PyTorch version; it is held against
the Pallas kernel run as tests/test_pallas_glcm.py runs it (interpret mode,
``need_diff_hist=False``). Tolerances: every integer-valued field is
bit-equal; ``dstats[3]``, a sum of non-integers, has the tolerances stated
beside its constants below. The kernel itself runs only on a GPU:
tests/test_torch_cuda.py compares it with the plain version there.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_parity import to_chw_tensor
from tpumcia.features.pallas_glcm import sufficient_stats_pallas
from tpumcia.features.stats import rescale_lut as jax_rescale_lut
from tpumcia.features.stats import sufficient_stats as jax_sufficient_stats
from tpumcia_torch.features import cuda_glcm
from tpumcia_torch.features.stats import cheap_limbs, glcm_sumsq_value, rescale_lut

INT_FIELDS = ("hist", "count", "vmax", "marg_l", "marg_r", "glcm_sumsq", "pair_count")
# dstats[3] = sum G/(1+d^2). The port sums it in float64 and rounds once, so
# against a float64 sum of the same difference histogram it agrees to f32
# rounding; and two sums in float64 (kernel vs plain version) to rel 1e-6.
DSTATS3_RTOL = 1e-6
# The Pallas kernel sums 65,536 f32 products G*(1/(1+d^2)) in f32: that
# sum's own rounding reaches ~1e-6 relative (1.02e-6 seen on small_batch).
PALLAS_DSTATS3_RTOL = 2e-6


def _edge_batch(small_batch):
    """small_batch[:2] with an all-zero channel and a constant channel."""
    x = small_batch[:2].copy()
    x[0, :, :, 1] = 0
    x[1, :, :, 2] = 77
    return x


def _assert_matches_jax(jax_stats, port_stats):
    for name in INT_FIELDS:
        a = np.asarray(getattr(jax_stats, name))
        b = getattr(port_stats, name).numpy()
        assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert port_stats.diff_hist is None
    a = np.asarray(jax_stats.dstats)
    b = port_stats.dstats.numpy()
    np.testing.assert_array_equal(a[..., :3], b[..., :3], err_msg="dstats[0..2]")
    np.testing.assert_allclose(b[..., 3], a[..., 3], rtol=PALLAS_DSTATS3_RTOL, atol=0)


@pytest.mark.parametrize("offset", [(0, 5), (3, -2)])
def test_stats_match_pallas_kernel(small_batch, offset):
    x = _edge_batch(small_batch)
    want = sufficient_stats_pallas(
        x, offset=offset, interpret=True, need_diff_hist=False
    )
    got = cuda_glcm.sufficient_stats(to_chw_tensor(x), levels=256, offset=offset)
    _assert_matches_jax(want, got)
    # the all-zero channel rescales through LUT row 0
    assert int(got.vmax[0, 1]) == 0 and int(got.vmax[1, 2]) == 77
    # homogeneity against a float64 sum of the Pallas kernel's own
    # difference histogram (need_diff_hist=True)
    dh = np.asarray(
        sufficient_stats_pallas(x, offset=offset, interpret=True).diff_hist, np.float64
    )
    d2 = (np.arange(511) - 255.0) ** 2
    np.testing.assert_allclose(
        got.dstats[..., 3].numpy(), (dh / (1.0 + d2)).sum(-1), rtol=1e-7, atol=0
    )


def test_generic_limbs_match_xla_stats():
    """72x72 is past the cheap gate (H*W > 4096): the generic sum(G^2)
    limbs and dstats encoding, against the XLA path's fields."""
    rng = np.random.default_rng(7)
    x = rng.integers(0, 256, size=(2, 72, 72, 2), dtype=np.uint8)
    x[1, :, :, 0] = 0
    assert not cheap_limbs(72 * 72, 256)
    want = jax_sufficient_stats(x, levels=256, offset=(0, 5))
    t = to_chw_tensor(x)
    got = cuda_glcm.sufficient_stats_reference(t, levels=256, offset=(0, 5), need_diff=True)
    for name in INT_FIELDS + ("diff_hist",):
        np.testing.assert_array_equal(
            np.asarray(getattr(want, name), np.float64),
            getattr(got, name).numpy().astype(np.float64),
            err_msg=name,
        )
    # dstats from the same difference histogram, in the generic encoding
    dh = np.asarray(want.diff_hist, np.int64)
    d = np.arange(511) - 255
    ds = cuda_glcm.sufficient_stats(t, levels=256, offset=(0, 5)).dstats.numpy()
    np.testing.assert_array_equal(ds[..., 0], (dh * (d * d >> 8)).sum(-1))
    np.testing.assert_array_equal(ds[..., 1], (dh * (d * d & 255)).sum(-1))
    np.testing.assert_array_equal(ds[..., 2], (dh * np.abs(d)).sum(-1))
    np.testing.assert_allclose(ds[..., 3], (dh / (1.0 + d * d)).sum(-1), rtol=DSTATS3_RTOL)


@pytest.mark.parametrize("shape,offset", [((1, 37, 53, 2), (1, 2)), ((2, 16, 16, 1), (-2, 1))])
def test_odd_sizes_and_offsets_match_pallas(shape, offset):
    rng = np.random.default_rng(11)
    x = rng.integers(0, 256, size=shape, dtype=np.uint8)
    want = sufficient_stats_pallas(x, offset=offset, interpret=True, need_diff_hist=False)
    got = cuda_glcm.sufficient_stats(to_chw_tensor(x), levels=256, offset=offset)
    _assert_matches_jax(want, got)


@pytest.mark.parametrize("levels", [16, 64, 256])
def test_rescale_lut_is_a_copy(levels):
    np.testing.assert_array_equal(rescale_lut(levels), jax_rescale_lut(levels))


def test_cheap_gate_matches_jax_gate():
    assert cheap_limbs(4096, 256)
    assert not cheap_limbs(4097, 256)
    assert not cheap_limbs(4096, 272)


def test_sumsq_value_reassembles_both_encodings():
    rng = np.random.default_rng(3)
    x = rng.integers(0, 4, size=(1, 1, 72, 72), dtype=np.int32)  # few levels, big cells
    st = cuda_glcm.sufficient_stats_reference(torch.from_numpy(x), levels=16, offset=(0, 1))
    xl = torch.from_numpy(x[..., :, :-1].reshape(1, -1)).long()
    xr = torch.from_numpy(x[..., :, 1:].reshape(1, -1)).long()
    lut = torch.from_numpy(rescale_lut(16)).long()[int(x.max())]
    g = torch.bincount((lut[xl] * 16 + lut[xr]).reshape(-1), minlength=256)
    assert glcm_sumsq_value(st.glcm_sumsq.numpy())[0, 0] == float((g * g).sum())


def test_wrapper_rejects_other_devices():
    x = torch.zeros((1, 1, 8, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        cuda_glcm.sufficient_stats(x, levels=256, offset=(0, 1))


def test_offset_without_pairs_raises():
    x = torch.zeros((1, 1, 4, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="no valid pairs"):
        cuda_glcm.sufficient_stats(x, levels=256, offset=(0, 4))


def test_import_leaves_jax_and_tpumcia_out():
    """Importing the port and every module of it leaves jax, tpumcia and
    sklearn out (the GPU machine has no jax and no sklearn)."""
    code = (
        "import sys, tpumcia_torch, tpumcia_torch.features.cuda_glcm, "
        "tpumcia_torch.features.hybrid, tpumcia_torch.models.fused, "
        "tpumcia_torch.models.forest_fit, tpumcia_torch.models.forest_device, "
        "tpumcia_torch.importance.mdi, tpumcia_torch.importance.permutation, "
        "tpumcia_torch.features.morphology, tpumcia_torch.features.props, "
        "tpumcia_torch.features.intensity_direct, tpumcia_torch.features.stats; "
        "bad = [m for m in sys.modules if m in ('jax', 'tpumcia', 'sklearn') "
        "or m.startswith(('jax.', 'tpumcia.', 'sklearn.'))]; assert not bad, bad"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)

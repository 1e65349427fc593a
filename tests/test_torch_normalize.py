"""tpumcia_torch.preprocess.normalize against tpumcia.preprocess.normalize.

Tolerances: quantize_to_levels, apply_mask and center_crop_or_pad are
bit-equal (the same int32 / float32 arithmetic); normalize_uint16 is
bit-equal (one f32 division); percentile_normalize agrees to 1e-6 (JAX
interpolates its percentile positions in float32, the port in float64, and
the result is a value in [0, 1]).
"""

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (one torch thread per worker)
from tpumcia.preprocess import normalize as jn
from tpumcia_torch.preprocess import normalize as tn


def test_quantize_uint16_full_range_is_bit_equal():
    v = np.arange(65536, dtype=np.uint16).reshape(4, 64, 64, 4)
    for levels in (256, 64, 16):
        want = np.asarray(jn.quantize_to_levels(v, levels=levels, src_levels=65536))
        got = tn.quantize_to_levels(v, levels=levels, src_levels=65536)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    # a uint16 tensor goes through its int16 bit pattern
    got = tn.quantize_to_levels(torch.from_numpy(v), levels=256, src_levels=65536)
    np.testing.assert_array_equal(got.numpy(), (v >> 8).astype(np.int32))


def test_quantize_float_and_int_inputs_are_bit_equal():
    rng = np.random.default_rng(0)
    f = rng.random((2, 16, 16, 3)).astype(np.float32)
    f[0, 0, 0] = [0.0, 1.0, 0.5 / 255]  # ends and a rounding tie
    for x in (f, f.astype(np.float64)):
        want = np.asarray(jn.quantize_to_levels(x, levels=256))
        np.testing.assert_array_equal(tn.quantize_to_levels(x, levels=256).numpy(), want)
    i = rng.integers(0, 4096, size=(2, 8, 8, 2), dtype=np.int32)
    want = np.asarray(jn.quantize_to_levels(i, levels=32, src_levels=4096))
    np.testing.assert_array_equal(tn.quantize_to_levels(i, levels=32, src_levels=4096).numpy(), want)
    with pytest.raises(ValueError, match="src_levels"):
        tn.quantize_to_levels(i, levels=32)
    with pytest.raises(ValueError, match="levels"):
        tn.quantize_to_levels(f, levels=0)


def test_normalize_uint16_is_bit_equal():
    v = np.arange(0, 65536, 17, dtype=np.uint16)[: 16 * 16 * 2].reshape(2, 16, 8, 2)
    np.testing.assert_array_equal(
        tn.normalize_uint16(v).numpy(), np.asarray(jn.normalize_uint16(v))
    )


@pytest.mark.parametrize("per_image", [True, False])
def test_percentile_normalize(per_image):
    rng = np.random.default_rng(1)
    x = rng.integers(0, 65536, size=(3, 20, 24, 2)).astype(np.uint16)
    x[1, :, :, 1] = 7  # constant channel: hi == lo
    want = np.asarray(jn.percentile_normalize(x, low=1.0, high=99.0, per_image=per_image))
    got = tn.percentile_normalize(x, low=1.0, high=99.0, per_image=per_image)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_apply_mask_and_center_crop_or_pad_are_bit_equal():
    rng = np.random.default_rng(2)
    x = rng.integers(0, 256, size=(2, 10, 13, 3), dtype=np.int32)
    shared = rng.random((2, 10, 13)) > 0.5
    per_ch = rng.random((2, 10, 13, 3)) > 0.5
    for m in (shared, per_ch.astype(np.uint8)):
        np.testing.assert_array_equal(
            tn.apply_mask(x, m, fill=5).numpy(), np.asarray(jn.apply_mask(x, m, fill=5))
        )
    for target in [(8, 8), (16, 20), (7, 20), (10, 13), (13, 11)]:
        np.testing.assert_array_equal(
            tn.center_crop_or_pad(x, target, fill=3).numpy(),
            np.asarray(jn.center_crop_or_pad(x, target, fill=3)),
            err_msg=str(target),
        )

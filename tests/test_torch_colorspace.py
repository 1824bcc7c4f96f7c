"""Port parity: selkies_tpu_torch.ops.colorspace against the JAX version.

Same seeded frames through both; the planes must be equal element for
element (the conversion is integer-exact, so the tolerance is zero)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from selkies_tpu.ops import colorspace as jcs
from selkies_tpu_torch.ops import colorspace as tcs


@pytest.mark.parametrize("h,w", [(2, 2), (48, 64), (98, 130)])
@pytest.mark.parametrize("fmt", ["bgrx", "rgb"])
def test_to_i420_matches_jax(h, w, fmt):
    rng = np.random.default_rng(h * 1000 + w)
    ch = 4 if fmt == "bgrx" else 3
    frame = rng.integers(0, 256, (h, w, ch), np.uint8)
    # saturated corners exercise the 16/235/240 clamps
    frame[0, 0] = 255
    frame[-1, -1] = 0
    jfn, tfn = ((jcs.bgrx_to_i420, tcs.bgrx_to_i420) if fmt == "bgrx"
                else (jcs.rgb_to_i420, tcs.rgb_to_i420))
    want = [np.asarray(p) for p in jfn(frame)]
    got = [p.numpy() for p in tfn(torch.from_numpy(frame))]
    for name, a, b in zip("yuv", want, got):
        assert b.dtype == np.uint8 and a.shape == b.shape, name
        np.testing.assert_array_equal(b, a, err_msg=name)


def test_extreme_colours_match_jax():
    """Every pure primary / grey level, where uint8 wrap would show first."""
    levels = np.array([0, 1, 127, 128, 254, 255], np.uint8)
    r, g, b = np.meshgrid(levels, levels, levels, indexing="ij")
    frame = np.stack([b, g, r, np.zeros_like(r)], -1).reshape(12, 18, 4)
    want = [np.asarray(p) for p in jcs.bgrx_to_i420(frame)]
    got = [p.numpy() for p in tcs.bgrx_to_i420(torch.from_numpy(frame))]
    for a, b_ in zip(want, got):
        np.testing.assert_array_equal(b_, a)

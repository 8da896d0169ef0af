"""The port's ROI-Align against the JAX package's three forms.

Inputs come from numpy with a seed and go through the JAX function and the
port's plain form.  Tolerances:
  * float32: 1e-5 absolute.  Both sides compute the same bilinear weights in
    float32 and sum at most four products per output in another order, on
    features of unit scale, so they differ by a few float32 ulps.
  * bfloat16: the port casts the features to bf16, accumulates in float32
    and rounds once, so it lies within half a bf16 ulp (2^-8 relative) of
    the float32 result on the same bf16 features.  The JAX XLA form instead
    rounds its weights and intermediate to bf16, so against it the bound is
    four bf16 ulps of the largest magnitude.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swapnet_tpu.ops.pallas_kernels import roi_align_pallas
from swapnet_tpu.ops.roi_align import roi_align as jax_roi_align
from swapnet_tpu.ops.roi_align import roi_align_reference
from swapnet_tpu_torch.ops import _build
from swapnet_tpu_torch.ops import roi_align as port_ops
from swapnet_tpu_torch.ops.roi_align import roi_align, roi_align_plain

F32_ATOL = 1e-5
BF16_EPS = 2.0 ** -7  # bf16 ulp at 1.0


def _boxes(rng, kind, B, R, H, W):
    if kind == "random":
        x1 = rng.uniform(0, W / 2, (B, R))
        y1 = rng.uniform(0, H / 2, (B, R))
        x2 = x1 + rng.uniform(2, W / 2, (B, R))
        y2 = y1 + rng.uniform(2, H / 2, (B, R))
    elif kind == "out_of_bounds":  # boxes that straddle and leave the image
        x1 = rng.uniform(-W, W, (B, R))
        y1 = rng.uniform(-H, H, (B, R))
        x2 = x1 + rng.uniform(1, 2 * W, (B, R))
        y2 = y1 + rng.uniform(1, 2 * H, (B, R))
    elif kind == "degenerate":  # zero, inverted and sub-pixel boxes, and the image edge
        x1 = rng.choice([0.0, W - 1.0, W - 0.5, 3.0], (B, R))
        y1 = rng.choice([0.0, H - 1.0, H - 0.5, 5.0], (B, R))
        x2 = x1 + rng.choice([0.0, -2.0, 0.25, 1.0], (B, R))
        y2 = y1 + rng.choice([0.0, -3.0, 0.5, 1.0], (B, R))
    else:
        raise ValueError(kind)
    return np.stack([x1, y1, x2, y2], -1).astype(np.float32)


def _inputs(seed, kind, B, H, W, C, R):
    rng = np.random.RandomState(seed)
    feats = rng.randn(B, H, W, C).astype(np.float32)
    return feats, _boxes(rng, kind, B, R, H, W)


def _port(feats, rois, out, dtype=None, fn=roi_align_plain):
    y = fn(torch.from_numpy(feats), torch.from_numpy(rois), output_size=out, dtype=dtype)
    return y.float().numpy()


KINDS = ["random", "out_of_bounds", "degenerate"]


@pytest.mark.parametrize("kind", KINDS)
def test_plain_matches_jax_xla_f32(kind):
    feats, rois = _inputs(0, kind, 2, 32, 24, 3, 5)
    ref = jax_roi_align(jnp.asarray(feats), jnp.asarray(rois), (8, 12), implementation="xla")
    np.testing.assert_allclose(_port(feats, rois, (8, 12)), np.asarray(ref), atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("kind", KINDS)
def test_plain_matches_pallas_interpret_f32(kind):
    feats, rois = _inputs(1, kind, 2, 32, 32, 3, 4)
    ref = roi_align_pallas(jnp.asarray(feats), jnp.asarray(rois), (8, 8), interpret=True)
    np.testing.assert_allclose(_port(feats, rois, (8, 8)), np.asarray(ref), atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("kind", KINDS)
def test_plain_matches_gather_reference_f32(kind):
    feats, rois = _inputs(2, kind, 1, 16, 20, 3, 3)
    ref = roi_align_reference(feats, rois, (6, 7))
    np.testing.assert_allclose(_port(feats, rois, (6, 7)), ref, atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("kind", KINDS)
def test_plain_matches_jax_at_path_shape(kind):
    """The texture stage's shape: 128^2, C=3, R=12, 128x128 output."""
    feats, rois = _inputs(3, kind, 1, 128, 128, 3, 12)
    ref = jax_roi_align(jnp.asarray(feats), jnp.asarray(rois), (128, 128), implementation="xla")
    np.testing.assert_allclose(_port(feats, rois, (128, 128)), np.asarray(ref),
                               atol=F32_ATOL, rtol=0)


def test_plain_sampling_ratio_2_matches_jax():
    feats, rois = _inputs(4, "random", 1, 24, 24, 2, 3)
    ref = jax_roi_align(jnp.asarray(feats), jnp.asarray(rois), (5, 5), sampling_ratio=2,
                        implementation="xla")
    ours = roi_align_plain(torch.from_numpy(feats), torch.from_numpy(rois), (5, 5),
                           sampling_ratio=2)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("kind", KINDS)
def test_plain_bf16_within_half_ulp_of_f32(kind):
    feats, rois = _inputs(5, kind, 1, 128, 128, 3, 12)
    feats_bf16 = torch.from_numpy(feats).to(torch.bfloat16)
    ours = roi_align_plain(feats_bf16, torch.from_numpy(rois), (128, 128))
    assert ours.dtype == torch.bfloat16
    ref = jax_roi_align(jnp.asarray(feats_bf16.float().numpy()), jnp.asarray(rois), (128, 128),
                        implementation="xla")
    ref = np.asarray(ref)
    err = np.abs(ours.float().numpy() - ref)
    assert np.all(err <= np.abs(ref) * BF16_EPS / 2 + 1e-6), err.max()


def test_plain_bf16_matches_jax_bf16():
    feats, rois = _inputs(6, "random", 1, 64, 64, 3, 12)
    ref = np.asarray(jax_roi_align(jnp.asarray(feats), jnp.asarray(rois), (64, 64),
                                   dtype=jnp.bfloat16, implementation="xla")).astype(np.float32)
    ours = _port(feats, rois, (64, 64), dtype=torch.bfloat16)
    assert np.max(np.abs(ours - ref)) <= 4 * BF16_EPS * np.max(np.abs(ref))


def test_dispatch_on_cpu_is_plain_and_counts_no_launch():
    feats, rois = _inputs(7, "random", 2, 16, 16, 3, 4)
    before = roi_align.launches
    a = _port(feats, rois, (8, 8), fn=roi_align)
    b = _port(feats, rois, (8, 8), fn=roi_align_plain)
    np.testing.assert_array_equal(a, b)
    assert roi_align.launches == before


def test_kernel_wrapper_refuses_cpu_tensors():
    """The launcher checks its inputs and never falls back to the plain form."""
    feats = torch.zeros(1, 3, 8, 8)
    rois = torch.zeros(1, 2, 4)
    with pytest.raises(ValueError, match="CUDA"):
        port_ops._launch(feats, rois, (4, 4), 1.0, 1)
    with pytest.raises(TypeError):
        port_ops._launch(feats.double(), rois, (4, 4), 1.0, 1)
    with pytest.raises(ValueError, match="sampling_ratio"):
        port_ops._launch(feats, rois, (4, 4), 1.0, 2)


def test_library_name_follows_source_hash(monkeypatch, tmp_path):
    src = tmp_path / "k.cu"
    src.write_text("// one")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build.library_path("k")
    src.write_text("// two")
    assert _build.library_path("k") != first
    assert first.parent == _build.BUILD and first.name.startswith("libk-")

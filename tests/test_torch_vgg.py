"""The port's VGG16Features and max_pool_2x2 against the JAX package.

The VGG runs at 32^2, B=2, float32, from one set of JAX variables carried
into the port by the bridge.  The JAX package's default width-packed block 1
(``block1_s2d=True``) returns tap 1 phase-packed; it is unpacked before the
comparison.  Tolerance: 1e-5 of each tap's largest magnitude (13 convs deep,
float32 sums in another order), and of the input gradient's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swapnet_tpu.models.vgg import VGG16Features as JaxVGG
from swapnet_tpu.models.vgg import load_torch_vgg16_features
from swapnet_tpu.ops.pooling import max_pool_2x2 as jax_pool
from swapnet_tpu_torch.models.vgg import (
    TORCHVISION_CONV_IDX, VGG16Features, vgg16_state_dict_from_torchvision)
from swapnet_tpu_torch.ops.pooling import max_pool_2x2
from swapnet_tpu_torch.utils.from_jax import load_from_jax, state_dict_from_jax

REL = 1e-5
B, SIZE = 2, 32


@pytest.fixture(scope="module")
def variables():
    return JaxVGG(conv_impl="xla").init(jax.random.key(0), jnp.zeros((1, SIZE, SIZE, 3)))


def _close(got, ref):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= REL * max(1.0, np.abs(ref).max()), err


@pytest.mark.parametrize("block1_s2d", [False, True])
def test_taps_and_input_gradient_match_jax(variables, block1_s2d):
    rng = np.random.RandomState(0)
    x = rng.uniform(-1, 1, (B, SIZE, SIZE, 3)).astype(np.float32)
    jvgg = JaxVGG(conv_impl="xla", block1_s2d=block1_s2d)
    taps_ref, vjp = jax.vjp(lambda x_: jvgg.apply(variables, x_), jnp.asarray(x))
    vgg = load_from_jax(VGG16Features(), variables)
    xt = torch.from_numpy(x).requires_grad_(True)
    taps = vgg(xt)
    cots = [rng.randn(*t.shape).astype(np.float32) for t in taps]
    assert len(taps) == len(taps_ref) == 5
    for i, (t, r) in enumerate(zip(taps, taps_ref)):
        if i == 0 and block1_s2d:
            r = jnp.reshape(r, t.shape)  # [B,H,W/2,2C] phase-packed -> [B,H,W,C]
        _close(t.detach(), r)
    cots_jax = [jnp.reshape(jnp.asarray(c), r.shape) for c, r in zip(cots, taps_ref)]
    (dx_ref,) = vjp(cots_jax)
    sum(((t * torch.from_numpy(c)).sum() for t, c in zip(taps, cots)), torch.zeros(())).backward()
    _close(xt.grad, dx_ref)


def test_torchvision_converter_matches_jax_loader(tmp_path):
    """One in-memory torchvision-style state dict through both converters."""
    rng = np.random.RandomState(1)
    sd, in_ch = {}, 3
    channels = [64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512]
    for idx, out_ch in zip(TORCHVISION_CONV_IDX, channels):
        sd[f"features.{idx}.weight"] = torch.from_numpy(
            rng.randn(out_ch, in_ch, 3, 3).astype(np.float32))
        sd[f"features.{idx}.bias"] = torch.from_numpy(rng.randn(out_ch).astype(np.float32))
        in_ch = out_ch
    sd["classifier.0.weight"] = torch.zeros(4, 4)  # ignored by both
    path = tmp_path / "vgg16.pth"
    torch.save(sd, path)
    jax_params = load_torch_vgg16_features(str(path))
    path.unlink()  # 59 MB, freed at once: pytest keeps every test's temporary files
    ours = vgg16_state_dict_from_torchvision(sd)
    via_jax = state_dict_from_jax(VGG16Features(), jax_params)
    assert sorted(ours) == sorted(via_jax)
    for k in ours:
        torch.testing.assert_close(ours[k], via_jax[k], rtol=0, atol=0)
    VGG16Features().load_state_dict(ours)  # strict: every parameter covered


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_max_pool_gradient_routes_ties_to_the_first_element(dtype):
    """Post-ReLU maps hold exact-zero ties; the gradient goes to the first
    maximal element of each window in row-major order, as the JAX custom
    VJP and torch's MaxPool2d do."""
    rng = np.random.RandomState(2)
    x = np.maximum(rng.randn(2, 8, 6, 5), 0).astype(np.float32)
    x[:, ::3] = 0.0  # whole rows of zero ties
    x[0, 2:4, 2:4, :] = 1.5  # a window of four equal maxima
    g = rng.randn(2, 4, 3, 5).astype(np.float32)
    y_ref, vjp = jax.vjp(jax_pool, jnp.asarray(x, dtype))
    (dx_ref,) = vjp(jnp.asarray(g, dtype))
    xt = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_(True)
    y = max_pool_2x2(xt)
    y.backward(torch.from_numpy(g).to(xt.dtype))
    np.testing.assert_array_equal(y.detach().float().numpy(), np.asarray(y_ref, np.float32))
    np.testing.assert_array_equal(xt.grad.float().numpy(), np.asarray(dx_ref, np.float32))
    assert (xt.grad[0, 2:4, 2:4] != 0).sum() == 5  # one of four per channel

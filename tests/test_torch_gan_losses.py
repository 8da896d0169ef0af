"""The port's GAN and perceptual losses against the JAX package's.

* ``gan_loss``: each ported mode on the same prediction map, with the label
  the JAX key draws handed to the port.  float32, 1e-6 relative.
* Smooth labels: ranges, the reference's fake-label bug, and that the draws
  come from the explicit generator only.
* ``perceptual_loss``: content and style (image gram and feature gram), in
  the cosine form and the reference's eps-outside form, and the gradient
  with respect to the generated image, through one VGG16 at 32^2 from one
  set of JAX variables.  float32, 1e-5 relative (13 convs deep).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swapnet_tpu.losses import GANLossConfig as JaxGANCfg
from swapnet_tpu.losses import PerceptualLossConfig as JaxPercCfg
from swapnet_tpu.losses import gan_loss as jax_gan_loss
from swapnet_tpu.losses import perceptual_loss as jax_perceptual_loss
from swapnet_tpu.models.vgg import VGG16Features as JaxVGG
from swapnet_tpu_torch.losses.gan import GANLossConfig, gan_label, gan_loss
from swapnet_tpu_torch.losses.perceptual import PerceptualLossConfig, perceptual_loss
from swapnet_tpu_torch.models.vgg import VGG16Features
from swapnet_tpu_torch.utils.from_jax import load_from_jax


def _rel_close(got, ref, rel):
    got = got.item() if isinstance(got, torch.Tensor) else float(got)
    ref = float(ref)
    assert abs(got - ref) <= rel * max(1.0, abs(ref)), (got, ref)


@pytest.mark.parametrize("real", [True, False])
@pytest.mark.parametrize("smooth", [True, False])
@pytest.mark.parametrize("mode", ["vanilla", "lsgan", "wgan"])
def test_gan_loss_matches_jax(mode, smooth, real):
    pred = np.random.RandomState(0).randn(2, 6, 6, 1).astype(np.float32) * 3
    key = jax.random.key(3)
    ref = jax_gan_loss(jnp.asarray(pred), real, JaxGANCfg(mode, smooth), key)
    cfg = GANLossConfig(mode, smooth)
    label = None
    if smooth and mode != "wgan":  # the scalar the JAX key draws
        low, high = cfg.real_range if real else cfg.fake_range
        label = float(jax.random.uniform(key, (), minval=low, maxval=high))
    got = gan_loss(torch.from_numpy(pred.transpose(0, 3, 1, 2).copy()), real, cfg, label=label)
    assert got.dtype == torch.float32 and got.dim() == 0
    _rel_close(got, ref, 1e-6)


def test_smooth_labels_draw_from_the_explicit_generator():
    before = torch.get_rng_state()
    draws = {}
    for name, cfg, real in (("real", GANLossConfig(), True), ("fake", GANLossConfig(), False),
                            ("bug", GANLossConfig(compat_fake_label_bug=True), False)):
        g = torch.Generator().manual_seed(0)
        draws[name] = torch.stack([gan_label(cfg, real, g) for _ in range(2000)])
    assert torch.equal(before, torch.get_rng_state())
    assert 0.7 <= draws["real"].min() and draws["real"].max() < 1.1
    assert 0.0 <= draws["fake"].min() and draws["fake"].max() < 0.3
    torch.testing.assert_close(draws["bug"], draws["real"], rtol=0, atol=0)
    assert draws["real"].std() > 0.1  # one fresh scalar per call
    g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    assert gan_label(GANLossConfig(), True, g1) == gan_label(GANLossConfig(), True, g2)
    with pytest.raises(ValueError, match="Generator"):
        gan_label(GANLossConfig(), True, None)
    with pytest.raises(NotImplementedError):
        GANLossConfig("wgan-gp")


@pytest.fixture(scope="module")
def vgg_pair():
    variables = JaxVGG(conv_impl="xla").init(jax.random.key(0), jnp.zeros((1, 32, 32, 3)))
    return variables, load_from_jax(VGG16Features(), variables)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(compat_eps_outside=True),
    dict(use_style=True, compat_image_gram=True),
    dict(use_style=True, compat_image_gram=False),
    dict(normalize=False),
], ids=["cosine", "eps_outside", "image_gram", "feature_gram", "plain_mse"])
def test_perceptual_loss_matches_jax(vgg_pair, kw):
    variables, vgg = vgg_pair
    rng = np.random.RandomState(1)
    out = rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    tgt = rng.uniform(0, 1, (2, 32, 32, 3)).astype(np.float32)
    jvgg = JaxVGG(conv_impl="xla")

    def f(o):
        return jax_perceptual_loss(lambda x: jvgg.apply(variables, x), o, jnp.asarray(tgt),
                                   JaxPercCfg(**kw))

    (content_ref, style_ref), vjp = jax.vjp(f, jnp.asarray(out))
    (dout_ref,) = vjp((jnp.float32(1.0), jnp.float32(1e-3)))

    o = torch.from_numpy(out.transpose(0, 3, 1, 2).copy()).requires_grad_(True)
    t = torch.from_numpy(tgt.transpose(0, 3, 1, 2).copy())
    content, style = perceptual_loss(vgg, o, t, PerceptualLossConfig(**kw))
    (content + 1e-3 * style).backward()
    _rel_close(content, content_ref, 1e-5)
    _rel_close(style, style_ref, 1e-5)
    dout = o.grad.permute(0, 2, 3, 1).numpy()
    scale = max(1e-6, np.abs(np.asarray(dout_ref)).max())
    assert np.abs(dout - np.asarray(dout_ref)).max() <= 1e-5 * scale

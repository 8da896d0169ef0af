"""WarpModule and TextureModule of the port against the JAX package at 64^2.

One set of JAX variables per generator (seeded numpy draws in the shapes
the JAX module declares) is carried into the port by the bridge; both JAX forms that compute the same function (the warp head's
``head_impl`` "s2d" and "xla", the texture stage's ``fuse_l0`` True and
False) are held against the port's one plain form, in eval mode, float32.

Tolerance: 1e-4 absolute.  A whole generator stacks ~20 convs with
instance norms between them; float32 sums taken in another order by XLA's
and oneDNN's convs drift by a few 1e-6 per layer, and the tanh output is
bounded by 1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swapnet_tpu.models.texture import TextureModule as JaxTexture
from swapnet_tpu.models.warp import WarpModule as JaxWarp
from swapnet_tpu_torch.models.texture import TextureModule
from swapnet_tpu_torch.models.warp import WarpModule
from swapnet_tpu_torch.utils.from_jax import load_from_jax

SIZE = 64
ATOL = 1e-4
# parameter counts of the default widths (independent of the image size)
WARP_PARAMS = 137_583_635
TEXTURE_PARAMS_64 = {"instance": 29_315_715, "batch": 29_318_019}


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def _count(tree):
    return sum(int(np.prod(np.shape(x))) for x in jax.tree.leaves(tree))


def _variables(module, seed, *args):
    """Seeded variables in the declared shapes: kernels ~ N(0, 2/fan_in),
    biases and BN shifts small, BN scales and variances near 1.  Drawing
    them with numpy costs a second where ``module.init`` on the CPU costs
    ~20 s for the warp stage."""
    rng = np.random.default_rng(seed)

    def draw(path, s):
        leaf, kind = path[-1].key, path[0].key
        if leaf == "kernel":
            scale = np.sqrt(2.0 / np.prod(s.shape[:-1]))
            return rng.standard_normal(s.shape, dtype=np.float32) * np.float32(scale)
        if leaf == "scale" or (kind == "batch_stats" and leaf == "var"):
            return rng.uniform(0.5, 1.5, s.shape).astype(np.float32)
        return (0.1 * rng.standard_normal(s.shape, dtype=np.float32)).astype(np.float32)

    shapes = jax.eval_shape(lambda: module.init(jax.random.key(0), *args, False))
    return jax.tree_util.tree_map_with_path(draw, shapes)


def _port(cls, variables, **kw):
    with torch.device("meta"):  # the bridge supplies every weight
        module = cls(**kw)
    return load_from_jax(module, variables).eval()


@pytest.fixture(scope="module")
def warp_inputs():
    rng = np.random.RandomState(0)
    body = rng.randn(1, SIZE, SIZE, 3).astype(np.float32)
    cloth = np.eye(19, dtype=np.float32)[rng.randint(0, 19, (1, SIZE, SIZE))]
    return body, cloth


@pytest.fixture(scope="module")
def warp_pair(warp_inputs):
    body, cloth = warp_inputs
    variables = _variables(JaxWarp(), 0, jnp.asarray(body), jnp.asarray(cloth))
    return variables, _port(WarpModule, variables)


@pytest.fixture(scope="module")
def warp_port_out(warp_pair, warp_inputs):
    body, cloth = warp_inputs
    with torch.no_grad():
        return warp_pair[1](_nchw(body), _nchw(cloth)).permute(0, 2, 3, 1).numpy()


def test_warp_parameter_count(warp_pair):
    variables, port = warp_pair
    n_port = sum(p.numel() for p in port.parameters())
    assert n_port == _count(variables["params"]) == WARP_PARAMS


@pytest.mark.parametrize("head_impl", ["s2d", "xla"])
def test_warp_module_matches_jax(warp_pair, warp_inputs, warp_port_out, head_impl):
    variables, _ = warp_pair
    body, cloth = warp_inputs
    apply = jax.jit(JaxWarp(head_impl=head_impl).apply, static_argnums=3)
    ref = np.asarray(apply(variables, jnp.asarray(body), jnp.asarray(cloth), False))
    assert warp_port_out.shape == ref.shape == (1, SIZE, SIZE, 19)
    np.testing.assert_allclose(warp_port_out, ref, atol=ATOL, rtol=0)


def test_warp_module_needs_64(warp_pair):
    with pytest.raises(ValueError, match="64"):
        warp_pair[1](torch.zeros(1, 3, 32, 64), torch.zeros(1, 19, 32, 64))


def _texture_inputs(seed):
    rng = np.random.RandomState(seed)
    tex = rng.randn(1, SIZE, SIZE, 3).astype(np.float32)
    x1 = rng.uniform(0, SIZE / 2, (1, 12))
    y1 = rng.uniform(0, SIZE / 2, (1, 12))
    rois = np.stack([x1, y1, x1 + rng.uniform(4, SIZE / 2, (1, 12)),
                     y1 + rng.uniform(4, SIZE / 2, (1, 12))], -1).astype(np.float32)
    cloth = np.eye(19, dtype=np.float32)[rng.randint(0, 19, (1, SIZE, SIZE))]
    return tex, rois, cloth


@pytest.mark.parametrize("norm_type", ["instance", "batch"])
def test_texture_module_matches_jax(norm_type):
    tex, rois, cloth = _texture_inputs(1)
    args = [jnp.asarray(a) for a in (tex, rois, cloth)]
    variables = _variables(JaxTexture(norm_type=norm_type, img_size=SIZE), 1, *args)
    port = _port(TextureModule, variables, norm_type=norm_type, img_size=SIZE)
    n_port = sum(p.numel() for p in port.parameters())
    assert n_port == _count(variables["params"]) == TEXTURE_PARAMS_64[norm_type]
    with torch.no_grad():
        ours = port(_nchw(tex), torch.from_numpy(rois), _nchw(cloth)).permute(0, 2, 3, 1).numpy()
    for fuse_l0 in (True, False):
        apply = jax.jit(JaxTexture(norm_type=norm_type, img_size=SIZE, fuse_l0=fuse_l0).apply,
                        static_argnums=4)
        ref = np.asarray(apply(variables, *args, False))
        np.testing.assert_allclose(ours, ref, atol=ATOL, rtol=0, err_msg=f"fuse_l0={fuse_l0}")

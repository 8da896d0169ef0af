"""Each layer of the port against its JAX module, weights carried by the
bridge (``swapnet_tpu_torch/utils/from_jax.py``).

Every JAX variable is replaced by seeded numpy draws (biases and batch-norm
statistics are not left at their trivial init), loaded into the port, and
both sides see the same NHWC input (NCHW for the port).  Tolerances:
  * pure data movement (activations, resizes, pads): exact;
  * float32 layers: 1e-5 absolute and relative, for sums of a few hundred
    products taken in another order (XLA's CPU convs vs oneDNN's);
  * bfloat16 instance norm: two bf16 ulps of each element plus one ulp at
    1.0, for elementwise bf16 math that both sides round at slightly
    different places.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from swapnet_tpu.models import layers as jl
from swapnet_tpu_torch.models import layers as tl
from swapnet_tpu_torch.utils.from_jax import (
    jax_variables_from_module, load_from_jax, state_dict_from_jax)

ATOL = RTOL = 1e-5
BF16_EPS = 2.0 ** -7


def _randomize(variables, seed):
    """Seeded replacements for every leaf, scaled like a trained net."""
    rng = np.random.RandomState(seed)
    out = {}
    for path, x in flatten_dict(jax.tree.map(np.asarray, dict(variables))).items():
        leaf, kind = path[-1], path[0]
        if leaf == "kernel":
            v = rng.randn(*x.shape) / np.sqrt(np.prod(x.shape[:-1]) / 2)
        elif leaf == "scale":
            v = 1.0 + 0.1 * rng.randn(*x.shape)
        elif kind == "batch_stats" and leaf == "var":
            v = rng.uniform(0.5, 1.5, x.shape)
        else:  # bias, mean
            v = 0.1 * rng.randn(*x.shape)
        out[path] = v.astype(np.float32)
    return unflatten_dict(out)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


def _nhwc(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def _pair(jax_mod, port_mod, *xs, seed=0, call=lambda m, v, *a: m.apply(v, *a)):
    """(JAX output, port output) of one layer on the same inputs and weights."""
    variables = _randomize(jax_mod.init(jax.random.key(seed), *[jnp.asarray(x) for x in xs]), seed)
    ref = np.asarray(jax.jit(lambda v, *a: call(jax_mod, v, *a))(
        variables, *[jnp.asarray(x) for x in xs]))
    load_from_jax(port_mod, variables).eval()
    with torch.no_grad():
        ours = port_mod(*[_nchw(x) for x in xs])
    return ref, _nhwc(ours)


def _x(seed, *shape, scale=1.0, offset=0.0):
    return (offset + scale * np.random.RandomState(seed).randn(*shape)).astype(np.float32)


def test_instance_norm_f32():
    x = _x(0, 2, 8, 8, 5, scale=2.0, offset=3.0)
    np.testing.assert_allclose(_nhwc(tl.instance_norm(_nchw(x))),
                               np.asarray(jl.instance_norm(jnp.asarray(x))), atol=ATOL, rtol=RTOL)


def test_instance_norm_bf16_single_pass():
    x = _x(1, 2, 16, 16, 4, scale=2.0, offset=1.0)
    ref = np.asarray(jl.instance_norm(jnp.asarray(x, jnp.bfloat16))).astype(np.float32)
    ours = tl.instance_norm(_nchw(x).to(torch.bfloat16))
    assert ours.dtype == torch.bfloat16
    err = np.abs(_nhwc(ours) - ref)
    assert np.all(err <= 2 * BF16_EPS * np.abs(ref) + BF16_EPS), err.max()


@pytest.mark.parametrize("op", ["leaky_relu", "upsample_nearest", "reflect_pad"])
def test_data_movement_ops_exact(op):
    x = _x(2, 2, 5, 6, 3)
    ref = np.asarray(getattr(jl, op)(jnp.asarray(x)))
    np.testing.assert_array_equal(_nhwc(getattr(tl, op)(_nchw(x))), ref)


@pytest.mark.parametrize("src,dst", [(8, 16), (16, 8), (6, 10), (10, 6), (7, 7)])
def test_resize_nearest_floor_indexing(src, dst):
    x = _x(3, 1, src, src + 1, 2)
    ref = np.asarray(jl.resize_nearest(jnp.asarray(x), dst, dst + 2))
    np.testing.assert_array_equal(_nhwc(tl.resize_nearest(_nchw(x), dst, dst + 2)), ref)


@pytest.mark.parametrize("k,s,p,bias,impl", [
    (4, 2, 1, False, "auto"), (3, 1, 0, True, "auto"), (4, 1, 1, True, "auto"),
    (4, 2, 1, True, "s2d_in"),
])
def test_conv(k, s, p, bias, impl):
    x = _x(4, 2, 12, 12, 6)
    ref, ours = _pair(jl.Conv(7, k, s, p, use_bias=bias, impl=impl),
                      tl.Conv(6, 7, k, s, p, use_bias=bias), x)
    np.testing.assert_allclose(ours, ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("impl", ["auto", "s2d"])
@pytest.mark.parametrize("bias", [False, True])
def test_conv_transpose_preflipped_hwoi(impl, bias):
    """The stored JAX kernel is pre-flipped HWOI; a wrong flip still fits."""
    x = _x(5, 2, 6, 5, 6)
    ref, ours = _pair(jl.ConvTranspose(5, use_bias=bias, impl=impl),
                      tl.ConvTranspose(6, 5, use_bias=bias), x)
    np.testing.assert_allclose(ours, ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("norm_type", ["instance", "batch", "none"])
def test_norm_eval(norm_type):
    x = _x(6, 2, 6, 6, 8, scale=1.5, offset=0.5)
    ref, ours = _pair(jl.Norm(norm_type), tl.Norm(norm_type, 8), x,
                      call=lambda m, v, a: m.apply(v, a, False))
    np.testing.assert_allclose(ours, ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("normalize", [True, False])
def test_unet_down(normalize):
    x = _x(7, 2, 16, 16, 5)
    ref, ours = _pair(jl.UNetDown(9, normalize=normalize, dropout=0.5),
                      tl.UNetDown(5, 9, normalize=normalize, dropout=0.5), x,
                      call=lambda m, v, a: m.apply(v, a, False))
    np.testing.assert_allclose(ours, ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("with_skip", [False, True])
def test_unet_up(with_skip):
    x = _x(8, 2, 4, 4, 12)
    skip = _x(9, 2, 8, 8, 3)
    if with_skip:
        ref, ours = _pair(jl.UNetUp(6, dropout=0.5), tl.UNetUp(12, 6, dropout=0.5), x, skip,
                          call=lambda m, v, a, b: m.apply(v, a, b, False))
    else:
        ref, ours = _pair(jl.UNetUp(6), tl.UNetUp(12, 6), x,
                          call=lambda m, v, a: m.apply(v, a, None, False))
    np.testing.assert_allclose(ours, ref, atol=ATOL, rtol=RTOL)


def test_dual_unet_up():
    x, s1, s2 = _x(10, 1, 4, 4, 16), _x(11, 1, 8, 8, 4), _x(12, 1, 8, 8, 5)
    ref, ours = _pair(jl.DualUNetUp(6), tl.DualUNetUp(16, 6), x, s1, s2,
                      call=lambda m, v, a, b, c: m.apply(v, a, b, c, False))
    np.testing.assert_allclose(ours, ref, atol=ATOL, rtol=RTOL)


def test_residual_block():
    x = _x(13, 2, 8, 8, 16)
    ref, ours = _pair(jl.ResidualBlock(dropout=0.5), tl.ResidualBlock(16, dropout=0.5), x,
                      call=lambda m, v, a: m.apply(v, a, False))
    np.testing.assert_allclose(ours, ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("impl", ["xla", "s2d"])
def test_upsample_pad_conv_tanh(impl):
    """The JAX default head is the space-to-depth form over the same kernel."""
    x = _x(14, 2, 8, 8, 12)
    ref, ours = _pair(jl.UpsamplePadConvTanh(5, impl=impl), tl.UpsamplePadConvTanh(12, 5), x)
    assert ours.shape == (2, 16, 16, 5)
    np.testing.assert_allclose(ours, ref, atol=ATOL, rtol=RTOL)


def test_bridge_round_trip_and_checks():
    port = tl.DualUNetUp(16, 6)
    norm = tl.Norm("batch", 8)
    for module in (port, norm):
        variables = jax_variables_from_module(module)
        back = state_dict_from_jax(module, variables)
        for k, v in module.state_dict().items():
            torch.testing.assert_close(back[k], v, rtol=0, atol=0)
    variables = jax_variables_from_module(port)
    variables["params"]["UNetUp_0"]["ConvTranspose_0"]["extra"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError):
        state_dict_from_jax(port, variables)
    variables = jax_variables_from_module(port)
    del variables["params"]["UNetUp_0"]["ConvTranspose_0"]["kernel"]
    with pytest.raises(KeyError):
        state_dict_from_jax(port, variables)
    variables = jax_variables_from_module(port)
    variables["params"]["UNetUp_0"]["ConvTranspose_0"]["kernel"] = np.zeros((4, 4, 6, 15))
    with pytest.raises(ValueError):
        state_dict_from_jax(port, variables)

"""The port's VGG conv3x3 (plain form, the CPU side of its CUDA kernel)
against the JAX package's ``conv3x3_bias_act``: the XLA form and the Pallas
kernel's body under the interpreter, forward and custom-VJP gradients.

Inputs are numpy draws from a seed.  Tolerances:
  * float32: 1e-5 of the largest magnitude of each compared tensor.  Both
    sides sum the same float32 products (at most 9*8 = 72 per output, and
    B*H*W = 256 per weight gradient) in another order.
  * bfloat16: both sides form the float32 sum of exact bf16 products, round
    it to bf16, add the bf16 bias and round again.  Sums taken in another
    order may straddle a rounding boundary once at each rounding, so the
    bound is two bf16 ulps (2^-7 relative) of |sum| + |result|, plus the
    float32 bound where the terms of a sum cancel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from swapnet_tpu.ops.conv3x3 import conv3x3_bias_act as jax_conv
from swapnet_tpu_torch.ops import conv3x3 as port_ops
from swapnet_tpu_torch.ops.conv3x3 import (
    conv3x3_bias_act, conv3x3_bias_act_plain, conv3x3_gemm, input_grad_matrix, weight_matrix)

F32_REL = 1e-5
BF16_ULP = 2.0 ** -7
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(seed, B, H, W, C, N):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, H, W, C).astype(np.float32)
    w = (rng.randn(3, 3, C, N) / np.sqrt(9 * C)).astype(np.float32)  # HWIO
    b = (0.5 * rng.randn(N)).astype(np.float32)
    g = rng.randn(B, H, W, N).astype(np.float32)
    return x, w, b, g


def _t(a, dtype, grad=False):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype).requires_grad_(grad)


def _close(name, got, ref, dtype, sums=None):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, name
    err = np.abs(got - ref)
    if dtype == "f32":
        limit = F32_REL * max(1.0, np.abs(ref).max())
        assert err.max() <= limit, f"{name}: {err.max():.3e} > {limit:.3e}"
    else:
        sums = np.abs(ref) if sums is None else np.abs(sums)
        bound = BF16_ULP * (sums + np.abs(ref)) + F32_REL * max(1.0, np.abs(ref).max())
        assert np.all(err <= bound), f"{name}: worst excess {(err - bound).max():.3e}"


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("C,N", [(3, 16), (8, 3), (8, 16), (3, 3)])
@pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
def test_forward_and_gradients_match_jax(impl, C, N, relu, dtype):
    jdt, tdt = DTYPES[dtype]
    x, w, b, g = _inputs(C * 100 + N, 2, 8, 16, C, N)
    impl_, interpret = ("pallas", True) if impl == "pallas_interpret" else ("xla", False)

    def f(x_, w_, b_):
        return jax_conv(x_, w_, b_, relu, impl_, interpret)

    args = [jnp.asarray(a, jdt) for a in (x, w, b)]
    y_ref, vjp = jax.vjp(f, *args)
    dx_ref, dw_ref, db_ref = vjp(jnp.asarray(g, jdt))

    xt, wt, bt = _t(x, tdt, True), _t(w.transpose(3, 2, 0, 1), tdt, True), _t(b, tdt, True)
    y = conv3x3_bias_act(xt, wt, bt, relu)
    assert y.dtype == tdt and tuple(y.shape) == (2, 8, 16, N)
    y.backward(_t(g, tdt))

    # the float32 sum before rounding, for the bf16 bound of the forward
    sums = np.asarray(jax_conv(*[jnp.asarray(a, jdt).astype(jnp.float32)
                                 for a in (x, w, 0 * b)], False, "xla", False))
    _close("y", y.detach().float(), y_ref, dtype, sums)
    _close("dx", xt.grad.float(), dx_ref, dtype)
    _close("dw", wt.grad.float().permute(2, 3, 1, 0), dw_ref, dtype)
    _close("db", bt.grad.float(), db_ref, dtype)


def test_gemm_matrices_are_the_pallas_kernels():
    """weight_matrix is _pallas_conv's tap-major w.reshape(9C, N); the
    input-gradient matrix is that of the custom VJP's flipped, in/out-swapped
    weights."""
    _, w, _, _ = _inputs(0, 1, 8, 8, 5, 7)
    w_oihw = torch.from_numpy(w.transpose(3, 2, 0, 1).copy())
    np.testing.assert_array_equal(weight_matrix(w_oihw, torch.float32).numpy(),
                                  w.reshape(9 * 5, 7))
    w_t = np.flip(w, (0, 1)).transpose(0, 1, 3, 2)
    np.testing.assert_array_equal(input_grad_matrix(w_oihw, torch.float32).numpy(),
                                  w_t.reshape(9 * 7, 5))


def test_plain_form_matches_autograd_function():
    x, w, b, g = _inputs(1, 2, 8, 8, 4, 6)
    outs = []
    for fn in (conv3x3_bias_act, conv3x3_bias_act_plain):
        xt, wt, bt = _t(x, torch.float32, True), _t(w.transpose(3, 2, 0, 1), torch.float32, True), \
            _t(b, torch.float32, True)
        y = fn(xt, wt, bt, True)
        y.backward(_t(g, torch.float32))
        outs.append([y.detach(), xt.grad, wt.grad, bt.grad])
    for a, ref in zip(*outs):
        np.testing.assert_allclose(a.numpy(), ref.numpy(), rtol=0,
                                   atol=F32_REL * max(1.0, ref.abs().max().item()))


def test_cpu_dispatch_counts_no_launch_and_frozen_weights_get_no_gradient():
    x, w, b, _ = _inputs(2, 1, 8, 8, 3, 4)
    before = conv3x3_bias_act.launches
    xt = _t(x, torch.float32, True)
    y = conv3x3_bias_act(xt, _t(w.transpose(3, 2, 0, 1), torch.float32), _t(b, torch.float32))
    y.sum().backward()
    assert xt.grad is not None and conv3x3_bias_act.launches == before


def test_kernel_wrapper_refuses_what_it_does_not_take():
    """The launcher checks its inputs and never falls back to the plain form."""
    x = torch.zeros(1, 8, 8, 3)
    wmat = torch.zeros(27, 4)
    bias = torch.zeros(4)
    with pytest.raises(ValueError, match="CUDA"):
        port_ops._launch(x, wmat, bias, True)
    with pytest.raises(TypeError):
        port_ops._launch(x.double(), wmat.double(), bias.double(), True)
    with pytest.raises(TypeError):
        port_ops._launch(x, wmat.bfloat16(), bias, True)
    with pytest.raises(ValueError, match="fit"):
        port_ops._launch(x, torch.zeros(26, 4), bias, True)
    with pytest.raises(ValueError, match="cuda or cpu"):
        conv3x3_gemm(x.to("meta"), wmat, bias, True)

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


# --- the kernel's plan and wrapper (no card needed) --------------------------

# VGG16 convs at 128^2: (size, C_in, C_out); a train step at B=8 runs each
# forward and its input gradient (C_out -> C_in, flipped weights)
VGG_CONVS = [(128, 3, 64), (128, 64, 64), (64, 64, 128), (64, 128, 128),
             (32, 128, 256), (32, 256, 256), (32, 256, 256),
             (16, 256, 512), (16, 512, 512), (16, 512, 512),
             (8, 512, 512), (8, 512, 512), (8, 512, 512)]
VGG_GEMMS = ([pytest.param(s, c, n, id=f"fwd{c}-{n}@{s}-{i}") for i, (s, c, n) in enumerate(VGG_CONVS)]
             + [pytest.param(s, n, c, id=f"dx{n}-{c}@{s}-{i}") for i, (s, c, n) in enumerate(VGG_CONVS)])
# edge shapes (B, H, W, C, N): batch 1 and 2, 2^2 and a non-square image
# (M not a multiple of 128), C = 3 and N = 3, C and N multiples of 8 but not
# of 32, an N that is not a multiple of 8, an odd N in a split
EDGE_SHAPES = [(1, 8, 8, 512, 512), (2, 2, 2, 512, 512), (2, 5, 7, 64, 128), (1, 5, 7, 3, 64),
               (2, 5, 7, 64, 3), (1, 2, 2, 3, 3), (2, 9, 11, 24, 40), (1, 16, 16, 512, 20),
               (1, 8, 8, 256, 13), (2, 95, 97, 24, 72)]


def _bf16_plan(B, H, W, C, N):
    plan = port_ops.conv3x3_plan(B, H, W, C, N, torch.bfloat16)
    code, bm, bn, bk, resident = port_ops.TC_TILES[plan.tile]
    tiles = -(-B * H * W // bm) * -(-N // bn)
    return plan, tiles, bk, resident


@pytest.mark.parametrize("S,C,N", VGG_GEMMS)
def test_plan_split_fills_the_card_in_one_wave(S, C, N):
    """Where K is split, the grid fits on the card at once (no second wave)
    and no further slice would: the blocks fill at least 90% of the SMs."""
    plan, tiles, _, resident = _bf16_plan(8, S, S, C, N)
    assert plan.blocks == tiles * plan.splits
    if plan.splits == 1:
        return
    assert tiles < port_ops.SMS
    assert plan.blocks <= resident * port_ops.SMS
    capped = plan.splits == plan.k_steps // port_ops.MIN_SLICE_STEPS
    assert capped or plan.blocks + tiles > resident * port_ops.SMS
    assert plan.blocks >= 0.9 * port_ops.SMS * resident


@pytest.mark.parametrize("S,C,N", VGG_GEMMS)
def test_plan_slices_hold_at_least_eight_steps(S, C, N):
    plan, _, bk, _ = _bf16_plan(8, S, S, C, N)
    assert plan.k_steps == -(-9 * C // bk)
    bounds = port_ops.slice_bounds(plan.k_steps, plan.splits)
    assert bounds[0][0] == 0 and bounds[-1][1] == plan.k_steps
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    if plan.splits > 1:
        assert min(b - a for a, b in bounds) >= port_ops.MIN_SLICE_STEPS >= 8


@pytest.mark.parametrize("S,C,N", VGG_GEMMS)
def test_plan_workspace_bytes(S, C, N):
    """float32 partial sums (splits, M, N) where split, none otherwise."""
    plan, _, _, _ = _bf16_plan(8, S, S, C, N)
    M = 8 * S * S
    assert plan.workspace_bytes == (4 * plan.splits * M * N if plan.splits > 1 else 0)
    assert plan.tile in port_ops.TC_TILES and port_ops.TC_TILES[plan.tile][2] >= min(N, 128)


@pytest.mark.parametrize("S,C,N", VGG_GEMMS)
def test_plan_float32_runs_the_cuda_core_form(S, C, N):
    plan = port_ops.conv3x3_plan(8, S, S, C, N, torch.float32)
    assert (plan.tile, plan.splits, plan.workspace_bytes) == ("cuda_core", 1, 0)
    with pytest.raises(ValueError, match="unsplit"):
        port_ops.conv3x3_plan(8, S, S, C, N, torch.float32, 2)


@pytest.mark.parametrize("B,H,W,C,N", EDGE_SHAPES)
def test_plan_at_edge_shapes(B, H, W, C, N):
    plan, tiles, _, _ = _bf16_plan(B, H, W, C, N)
    assert 1 <= plan.splits <= plan.k_steps and plan.blocks == tiles * plan.splits
    forced = port_ops.conv3x3_plan(B, H, W, C, N, torch.bfloat16, 1)
    assert (forced.tile, forced.splits, forced.workspace_bytes) == (plan.tile, 1, 0)
    with pytest.raises(ValueError, match="splits"):
        port_ops.conv3x3_plan(B, H, W, C, N, torch.bfloat16, plan.k_steps + 1)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("B,H,W,C,N", EDGE_SHAPES)
def test_plain_form_matches_jax_at_edge_shapes(B, H, W, C, N, dtype):
    """The plain form (what the card's kernels are held to) against the JAX
    XLA form, and its split partial sums, summed, against the unsplit sum."""
    jdt, tdt = DTYPES[dtype]
    x, w, b, _ = _inputs(B * 1000 + H * 100 + C + N, B, H, W, C, N)
    relu = N % 2 == 0
    y_ref = jax_conv(*[jnp.asarray(a, jdt) for a in (x, w, b)], relu, "xla", False)
    sums = np.asarray(jax_conv(*[jnp.asarray(a, jdt).astype(jnp.float32) for a in (x, w, 0 * b)],
                               False, "xla", False))
    xt, bt = _t(x, tdt), _t(b, tdt)
    wmat = weight_matrix(_t(w.transpose(3, 2, 0, 1), torch.float32), tdt)
    y = port_ops.conv3x3_gemm(xt, wmat, bt, relu)
    assert y.dtype == tdt and tuple(y.shape) == (B, H, W, N)
    _close("y", y.float(), y_ref, dtype, sums)
    splits = port_ops.conv3x3_plan(B, H, W, C, N, torch.bfloat16).splits
    parts = port_ops.conv3x3_partials_plain(xt, wmat, splits)
    assert tuple(parts.shape) == (splits, B, H, W, N) and parts.dtype == torch.float32
    whole = port_ops.conv3x3_gemm_plain(xt.float(), wmat.float(), torch.zeros(N), False)
    np.testing.assert_allclose(parts.sum(0).numpy(), whole.numpy(), rtol=0,
                               atol=F32_REL * max(1.0, whole.abs().max().item()))


def test_wrapper_refuses_mixed_devices_types_and_layouts_without_a_card():
    x = torch.zeros(1, 8, 8, 16, dtype=torch.bfloat16)
    wmat = torch.zeros(144, 8, dtype=torch.bfloat16)
    bias = torch.zeros(8, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="same CUDA device"):
        port_ops._launch(x, wmat.to("meta"), bias, True)  # a CPU tensor beside another device
    with pytest.raises(ValueError, match="same CUDA device"):
        port_ops.conv3x3_partials(x, wmat, 1)
    with pytest.raises(TypeError):
        port_ops._launch(x.half(), wmat.half(), bias.half(), True)
    with pytest.raises(TypeError, match="one type"):
        port_ops._launch(x, wmat, bias.float(), True)
    with pytest.raises(TypeError, match="bfloat16 form"):
        port_ops.conv3x3_partials(x.float(), wmat.float(), 1)
    with pytest.raises(ValueError, match="contiguous"):
        port_ops._launch(x.transpose(1, 2), wmat, bias, True)
    with pytest.raises(ValueError, match="contiguous"):
        port_ops._launch(x, torch.zeros(8, 144, dtype=torch.bfloat16).t(), bias, True)
    with pytest.raises(TypeError):
        port_ops.conv3x3_plan(1, 8, 8, 16, 8, torch.float16)


def test_chip_smoke_watchdog_ends_an_overrunning_phase():
    """A phase past its budget ends the run loudly: non-zero exit, every
    thread's stack on stderr, after the phase's start line."""
    import subprocess
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    code = ("import time, chip_smoke\n"
            "chip_smoke.PHASE_BUDGET_S['nap'] = 1\n"
            "chip_smoke.timed('nap', time.sleep, 60)\n")
    run = subprocess.run([sys.executable, "-B", "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=60)
    assert run.returncode != 0
    assert "[phase] nap starts (watchdog 1 s)" in run.stdout
    assert "Timeout" in run.stderr and "in timed" in run.stderr
    assert "took" not in run.stdout

"""3x3, stride-1, pad-1 conv + bias + optional ReLU for the frozen VGG16,
counterpart of ``swapnet_tpu/ops/conv3x3.py::conv3x3_bias_act``.

Layout: activations channels-last, x (B, H, W, C) -> (B, H, W, N), as in
the JAX package; the weight is the module's (N, C, 3, 3) OIHW parameter,
bias (N,).  The VGG converts its input to channels-last once and keeps
every conv, pool and tap in that layout, so no conv pays a transpose.

The product itself is ``conv3x3_gemm(x, wmat, bias, relu)`` over the
tap-major (9C, N) weight matrix (row (dy*3 + dx)*C + c), which dispatches on
where ``x`` lies: a CUDA tensor goes to the hand-written kernel
``csrc/conv3x3.cu`` (implicit GEMM, float32 sums), or the call raises; a CPU
tensor goes to ``conv3x3_gemm_plain``.  There is no fallback from the kernel
to the plain form.  ``conv3x3_bias_act.launches`` counts kernel launches.

Numerics (both forms, as ``_kernel`` and flax.linen.Conv): the sum is
float32, rounded to the compute type, then the bias is added in that type,
then the ReLU.

``conv3x3_bias_act`` is a ``torch.autograd.Function`` with the JAX custom
VJP's rule: the output gradient, masked by ``y > 0`` for the ReLU, goes
through the same kernel with the weights flipped in both spatial axes and
in/out swapped, zero bias and no ReLU.  The weight and bias gradients are
plain torch, computed only when asked for (never for the frozen VGG).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from swapnet_tpu_torch.ops import _build


def weight_matrix(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(N, C, 3, 3) OIHW -> the forward GEMM's (9C, N) tap-major matrix."""
    N, C = w.shape[:2]
    return w.permute(2, 3, 1, 0).reshape(9 * C, N).to(dtype).contiguous()


def input_grad_matrix(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(N, C, 3, 3) OIHW -> the input gradient's (9N, C) matrix: taps
    flipped in both spatial axes, in and out swapped."""
    N, C = w.shape[:2]
    return w.flip(2, 3).permute(2, 3, 0, 1).reshape(9 * N, C).to(dtype).contiguous()


def conv3x3_gemm_plain(x: torch.Tensor, wmat: torch.Tensor, bias: torch.Tensor,
                       relu: bool) -> torch.Tensor:
    """The plain PyTorch form of the kernel on any device: x (B, H, W, C),
    wmat (9C, N), bias (N,), all of one type -> (B, H, W, N)."""
    C = x.shape[-1]
    N = wmat.shape[1]
    w = wmat.reshape(3, 3, C, N).permute(3, 2, 0, 1)
    acc = F.conv2d(x.permute(0, 3, 1, 2).float(), w.float(), padding=1)
    y = acc.to(x.dtype) + bias.to(x.dtype)[:, None, None]
    if relu:
        y = torch.relu(y)
    return y.permute(0, 2, 3, 1).contiguous()


@functools.cache
def _kernel_fn():
    """The C entry point of csrc/conv3x3.cu, built and typed on first use."""
    fn = _build.load("conv3x3").conv3x3_forward
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(x: torch.Tensor, wmat: torch.Tensor, bias: torch.Tensor, relu: bool) -> torch.Tensor:
    """Run the CUDA kernel: (B, H, W, C) -> (B, H, W, N)."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"conv3x3 kernel takes float32 or bfloat16, got {x.dtype}")
    if wmat.dtype != x.dtype or bias.dtype != x.dtype:
        raise TypeError(f"conv3x3 kernel takes one type, got x {x.dtype}, weights "
                        f"{wmat.dtype}, bias {bias.dtype}")
    if x.dim() != 4 or wmat.dim() != 2 or bias.dim() != 1:
        raise ValueError(f"expected x (B,H,W,C), wmat (9C,N) and bias (N,), got "
                         f"{tuple(x.shape)}, {tuple(wmat.shape)} and {tuple(bias.shape)}")
    B, H, W, C = x.shape
    N = wmat.shape[1]
    if wmat.shape[0] != 9 * C or bias.shape[0] != N:
        raise ValueError(f"wmat {tuple(wmat.shape)} and bias {tuple(bias.shape)} do not fit "
                         f"C={C}")
    if not (x.is_cuda and wmat.device == x.device and bias.device == x.device):
        raise ValueError("x, wmat and bias must lie on the same CUDA device")
    if not (x.is_contiguous() and wmat.is_contiguous() and bias.is_contiguous()):
        raise ValueError("conv3x3 kernel takes contiguous tensors")
    out = torch.empty((B, H, W, N), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = _kernel_fn()(
        x.data_ptr(), wmat.data_ptr(), bias.data_ptr(), out.data_ptr(),
        int(x.dtype == torch.bfloat16), B, H, W, C, N, int(relu), x.device.index or 0, stream)
    if rc != 0:
        raise RuntimeError(f"conv3x3 kernel launch failed with CUDA error {rc}")
    conv3x3_bias_act.launches += 1
    return out


def conv3x3_gemm(x: torch.Tensor, wmat: torch.Tensor, bias: torch.Tensor,
                 relu: bool) -> torch.Tensor:
    """The conv as its GEMM: the CUDA kernel for a CUDA tensor, the plain
    form for a CPU tensor."""
    if x.device.type == "cuda":
        return _launch(x.contiguous(), wmat, bias, relu)
    if x.device.type == "cpu":
        return conv3x3_gemm_plain(x, wmat, bias, relu)
    raise ValueError(f"conv3x3 runs on cuda or cpu, not {x.device}")


class _Conv3x3BiasAct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, b, relu):
        y = conv3x3_gemm(x, weight_matrix(w, x.dtype), b.to(x.dtype).contiguous(), relu)
        ctx.relu, ctx.b_dtype = relu, b.dtype
        ctx.save_for_backward(x, w, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, w, y = ctx.saved_tensors
        g = g.to(x.dtype)
        if ctx.relu:
            g = torch.where(y > 0, g, torch.zeros((), dtype=g.dtype, device=g.device))
        g = g.contiguous()
        dx = dw = db = None
        if ctx.needs_input_grad[0]:
            zero_bias = torch.zeros(x.shape[-1], dtype=x.dtype, device=x.device)
            dx = conv3x3_gemm(g, input_grad_matrix(w, x.dtype), zero_bias, False)
        if ctx.needs_input_grad[1]:
            dw = torch.nn.grad.conv2d_weight(
                x.permute(0, 3, 1, 2).float(), w.shape, g.permute(0, 3, 1, 2).float(),
                padding=1).to(w.dtype)
        if ctx.needs_input_grad[2]:
            db = g.float().sum(dim=(0, 1, 2)).to(ctx.b_dtype)
        return dx, dw, db, None


def conv3x3_bias_act(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     relu: bool = True) -> torch.Tensor:
    """x (B, H, W, C) channels-last, w (N, C, 3, 3), b (N,) -> (B, H, W, N)
    in x's type; differentiable in all three."""
    return _Conv3x3BiasAct.apply(x, w, b, relu)


conv3x3_bias_act.launches = 0


def conv3x3_bias_act_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                           relu: bool = True) -> torch.Tensor:
    """The plain PyTorch form of ``conv3x3_bias_act`` on any device, same
    layout and numerics; differentiated by autograd."""
    return conv3x3_gemm_plain(x, weight_matrix(w, x.dtype), b, relu)

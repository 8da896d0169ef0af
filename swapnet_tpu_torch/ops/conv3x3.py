"""3x3, stride-1, pad-1 conv + bias + optional ReLU for the frozen VGG16,
counterpart of ``swapnet_tpu/ops/conv3x3.py::conv3x3_bias_act``.

Layout: activations channels-last, x (B, H, W, C) -> (B, H, W, N), as in
the JAX package; the weight is the module's (N, C, 3, 3) OIHW parameter,
bias (N,).  The VGG converts its input to channels-last once and keeps
every conv, pool and tap in that layout, so no conv pays a transpose.

The product itself is ``conv3x3_gemm(x, wmat, bias, relu)`` over the
tap-major (9C, N) weight matrix (row (dy*3 + dx)*C + c), which dispatches on
where ``x`` lies: a CUDA tensor goes to the hand-written kernels of
``csrc/conv3x3.cu``, or the call raises; a CPU tensor goes to
``conv3x3_gemm_plain``.  There is no fallback from the kernels to the plain
form, and no switch between kernels: ``conv3x3_plan`` picks the form from
the shapes and the type alone.  bfloat16 runs on the tensor cores
(``mma.sync``), with K split into slices summed by a second kernel where the
output tiles do not fill the card; float32 runs on the CUDA cores.
``conv3x3_bias_act.launches`` counts conv calls that launched a kernel and
``conv3x3_bias_act.splitk_reduces`` the split-K sums among them.

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
from typing import NamedTuple, Optional

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


SMS = 132  # streaming multiprocessors of an H100 SXM
MIN_SLICE_STEPS = 8  # K steps of the shortest slice a split may make
# tensor-core tiles of csrc/conv3x3.cu: name -> (the C entry point's
# ``tile`` code, BM, BN, BK, blocks that fit on one SM at once)
TC_TILES = {
    "tc128x128k64": (1, 128, 128, 64, 2),
    "tc128x128k64db": (2, 128, 128, 64, 1),
    "tc256x64k32": (3, 256, 64, 32, 2),
    "tc128x64k64": (4, 128, 64, 64, 2),
    "tc128x16k64": (5, 128, 16, 64, 2),
}


class Conv3x3Plan(NamedTuple):
    """How one conv runs on the card: the kernel form and its tile, the
    number of K slices and what that launches.  For "cuda_core" the kernel
    picks its tile by N itself (csrc/conv3x3.cu dispatch_f32) and the other
    fields are 1 slice and 0."""
    tile: str  # "cuda_core" or a key of TC_TILES
    splits: int
    k_steps: int  # K steps of the whole product
    blocks: int  # blocks of the conv kernel's grid, slices included
    workspace_bytes: int  # float32 partial sums, (splits, M, N); 0 unsplit


def _tc_plan(tile: str, B: int, H: int, W: int, C: int, N: int,
             splits: Optional[int] = None) -> Conv3x3Plan:
    """The plan of the tensor-core kernel with ``tile``: where its tiles
    number fewer than the SMs, K is split into S slices of whole steps, as
    many as keep the grid within the blocks that fit on the card at once,
    each slice at least ``MIN_SLICE_STEPS`` steps long."""
    _, bm, bn, bk, resident = TC_TILES[tile]
    M = B * H * W
    k_steps = -(-9 * C // bk)
    tiles = -(-M // bm) * -(-N // bn)
    if splits is None:
        splits = 1
        if tiles < SMS:
            splits = max(1, min(resident * SMS // tiles, k_steps // MIN_SLICE_STEPS))
    elif not 1 <= splits <= k_steps:
        raise ValueError(f"splits must lie in 1..{k_steps}, got {splits}")
    workspace = 4 * splits * M * N if splits > 1 else 0
    return Conv3x3Plan(tile, splits, k_steps, tiles * splits, workspace)


@functools.lru_cache(maxsize=None)
def conv3x3_plan(B: int, H: int, W: int, C: int, N: int, dtype: torch.dtype,
                 splits: Optional[int] = None) -> Conv3x3Plan:
    """The plan for one (B, H, W, C) -> (B, H, W, N) conv in ``dtype``.

    float32 runs the CUDA-core kernel, unsplit.  bfloat16 runs the
    tensor-core kernel with a tile chosen by N and by whether the tiles fill
    the card, split as ``_tc_plan`` says.  ``splits`` overrides S for the
    bfloat16 form (1 <= S <= K steps) on the same tile, to hold a split
    against the unsplit product.
    """
    if dtype == torch.float32:
        if splits not in (None, 1):
            raise ValueError("the float32 conv3x3 runs unsplit")
        return Conv3x3Plan("cuda_core", 1, 0, 0, 0)
    if dtype != torch.bfloat16:
        raise TypeError(f"conv3x3 kernel takes float32 or bfloat16, got {dtype}")
    M = B * H * W
    if N <= 16:
        tile = "tc128x16k64"
    elif N <= 64:
        # 256-pixel tiles where they fill the card (and for the element-wise
        # gather of x, whose K = 27 fills one 32-deep step)
        tile = "tc256x64k32" if -(-M // 256) >= SMS or C % 8 else "tc128x64k64"
    else:
        # two blocks per SM where the tiles fill the card; else one block per
        # SM with the next substep's operands read while the products run,
        # and K split to fill the card
        tile = "tc128x128k64" if -(-M // 128) * -(-N // 128) >= SMS else "tc128x128k64db"
    return _tc_plan(tile, B, H, W, C, N, splits)


def slice_bounds(k_steps: int, splits: int):
    """The K steps [start, end) of each slice, as the kernel cuts them."""
    return [(s * k_steps // splits, (s + 1) * k_steps // splits) for s in range(splits)]


@functools.cache
def _library():
    lib = _build.load("conv3x3")
    lib.conv3x3_init.argtypes = [ctypes.c_int]
    lib.conv3x3_init.restype = ctypes.c_int
    lib.conv3x3_forward.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
    lib.conv3x3_forward.restype = ctypes.c_int
    return lib


@functools.cache
def _kernel_fn(device: int):
    """The C entry point of csrc/conv3x3.cu, built and typed on first use,
    with every tensor-core instantiation opted in to its shared memory on
    ``device`` before the first launch there."""
    lib = _library()
    rc = lib.conv3x3_init(device)
    if rc != 0:
        raise RuntimeError(f"conv3x3 kernel init failed with CUDA error {rc}")
    return lib.conv3x3_forward


def _check(x: torch.Tensor, wmat: torch.Tensor, bias: Optional[torch.Tensor]) -> None:
    """Raise on what the kernels do not take; touches no card."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"conv3x3 kernel takes float32 or bfloat16, got {x.dtype}")
    if wmat.dtype != x.dtype or (bias is not None and bias.dtype != x.dtype):
        raise TypeError(f"conv3x3 kernel takes one type, got x {x.dtype}, weights "
                        f"{wmat.dtype}, bias {None if bias is None else bias.dtype}")
    if x.dim() != 4 or wmat.dim() != 2 or (bias is not None and bias.dim() != 1):
        raise ValueError(f"expected x (B,H,W,C), wmat (9C,N) and bias (N,), got "
                         f"{tuple(x.shape)}, {tuple(wmat.shape)} and "
                         f"{None if bias is None else tuple(bias.shape)}")
    if wmat.shape[0] != 9 * x.shape[-1] or (bias is not None and bias.shape[0] != wmat.shape[1]):
        raise ValueError(f"wmat {tuple(wmat.shape)} and bias "
                         f"{None if bias is None else tuple(bias.shape)} do not fit "
                         f"C={x.shape[-1]}")
    tensors = [t for t in (x, wmat, bias) if t is not None]
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("conv3x3 kernel takes contiguous tensors")
    if not (x.is_cuda and all(t.device == x.device for t in tensors)):
        raise ValueError("x, wmat and bias must lie on the same CUDA device")


def _padded(wmat: torch.Tensor) -> torch.Tensor:
    """The bfloat16 kernel reads Wm in 16-byte copies: its rows padded with
    zeros to a multiple of 8 columns, 16-byte aligned (a copy only where
    that is not so already; the weights are small)."""
    N = wmat.shape[1]
    if N % 8 == 0 and wmat.data_ptr() % 16 == 0:
        return wmat
    return F.pad(wmat, (0, -N % 8))


def _run(x, wmat, bias, out, ws, plan: Conv3x3Plan, relu: bool, reduce: bool, N: int) -> None:
    B, H, W, C = x.shape
    device = x.device.index or 0
    stream = torch.cuda.current_stream(x.device).cuda_stream
    tile = 0 if plan.tile == "cuda_core" else TC_TILES[plan.tile][0]
    if tile:
        wmat = _padded(wmat)

    def ptr(t):
        return None if t is None else t.data_ptr()

    rc = _kernel_fn(device)(
        ptr(x), ptr(wmat), ptr(bias), ptr(out), ptr(ws), int(x.dtype == torch.bfloat16),
        B, H, W, C, N, wmat.shape[1], int(relu), tile, plan.splits, int(reduce), device, stream)
    if rc != 0:
        raise RuntimeError(f"conv3x3 kernel launch failed with CUDA error {rc} ({plan})")


def _launch(x: torch.Tensor, wmat: torch.Tensor, bias: torch.Tensor, relu: bool,
            splits: Optional[int] = None) -> torch.Tensor:
    """Run the CUDA kernels: (B, H, W, C) -> (B, H, W, N)."""
    _check(x, wmat, bias)
    B, H, W, C = x.shape
    N = wmat.shape[1]
    plan = conv3x3_plan(B, H, W, C, N, x.dtype, splits)
    out = torch.empty((B, H, W, N), dtype=x.dtype, device=x.device)
    ws = None
    if plan.splits > 1:
        ws = torch.empty((plan.splits, B * H * W, N), dtype=torch.float32, device=x.device)
    _run(x, wmat, bias, out, ws, plan, relu, True, N)
    conv3x3_bias_act.launches += 1
    if ws is not None:
        conv3x3_bias_act.splitk_reduces += 1
    return out


def conv3x3_partials(x: torch.Tensor, wmat: torch.Tensor, splits: int) -> torch.Tensor:
    """The bfloat16 tensor-core kernel's float32 partial sums over ``splits``
    K slices, (splits, B, H, W, N), before they are summed and rounded: the
    split form's workspace, to hold against ``conv3x3_partials_plain``."""
    if x.dtype != torch.bfloat16:
        raise TypeError("only the bfloat16 form is split")
    _check(x, wmat, None)
    B, H, W, C = x.shape
    N = wmat.shape[1]
    plan = conv3x3_plan(B, H, W, C, N, x.dtype, splits)
    ws = torch.empty((plan.splits, B, H, W, N), dtype=torch.float32, device=x.device)
    _run(x, wmat, None, None, ws, plan, False, False, N)
    conv3x3_bias_act.launches += 1
    return ws


def conv3x3_partials_plain(x: torch.Tensor, wmat: torch.Tensor, splits: int) -> torch.Tensor:
    """The plain form of ``conv3x3_partials`` on any device: the float32 sum
    over each slice's K rows of the im2col product, (splits, B, H, W, N),
    cut into slices as the bfloat16 plan cuts them."""
    B, H, W, C = x.shape
    N = wmat.shape[1]
    plan = conv3x3_plan(B, H, W, C, N, torch.bfloat16, splits)
    bk = TC_TILES[plan.tile][3]
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    cols = torch.cat([xp[:, dy:dy + H, dx:dx + W] for dy in range(3) for dx in range(3)], -1)
    return torch.stack([cols[..., a * bk:b * bk] @ wmat[a * bk:b * bk].float()
                        for a, b in slice_bounds(plan.k_steps, splits)])


def conv3x3_gemm(x: torch.Tensor, wmat: torch.Tensor, bias: torch.Tensor,
                 relu: bool, splits: Optional[int] = None) -> torch.Tensor:
    """The conv as its GEMM: the CUDA kernels for a CUDA tensor, the plain
    form for a CPU tensor.  ``splits`` overrides the planned K slices of the
    bfloat16 kernel (the plain form has none)."""
    if x.device.type == "cuda":
        return _launch(x.contiguous(), wmat, bias, relu, splits)
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
conv3x3_bias_act.splitk_reduces = 0


def conv3x3_bias_act_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                           relu: bool = True) -> torch.Tensor:
    """The plain PyTorch form of ``conv3x3_bias_act`` on any device, same
    layout and numerics; differentiated by autograd."""
    return conv3x3_gemm_plain(x, weight_matrix(w, x.dtype), b, relu)

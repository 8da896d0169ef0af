"""ROI-Align (torchvision ``aligned=False``), counterpart of
``swapnet_tpu/ops/roi_align.py``.

``roi_align`` dispatches on where the features lie: a CPU tensor goes to
``roi_align_plain``, the separable form of ``_roi_align_xla``
(``Wy . img . Wx^T`` per batch and ROI); a CUDA tensor goes to the
hand-written kernel ``csrc/roi_align.cu`` (the direct 4-corner gather), or
the call raises.  There is no fallback from the kernel to the plain form.

The public layout is the JAX package's: features NHWC (B, H, W, C), ROIs
(B, R, 4) as [x1, y1, x2, y2], output (B, R, out_h, out_w, C).  Internally
the features are NCHW and the output (B, R, C, out_h, out_w), which the
texture stage views as (B, R*C, out_h, out_w); the permutes between the two
are views, so a NCHW caller pays no copy.

Both forms accumulate in float32 and return the features' type (or
``dtype`` when given).  ``roi_align.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from swapnet_tpu_torch.ops import _build


def _axis_weights(
    start: torch.Tensor,  # (B, R) roi start along this axis
    bin_size: torch.Tensor,  # (B, R)
    out_size: int,
    in_size: int,
    sampling_ratio: int,
) -> torch.Tensor:
    """Dense (B, R, out_size, in_size) bilinear weights for one axis, with
    the validity, clamp and edge rules of ``_axis_weights`` in the JAX
    package."""
    dev = start.device
    i = torch.arange(out_size, dtype=torch.float32, device=dev)
    s = (torch.arange(sampling_ratio, dtype=torch.float32, device=dev) + 0.5) / sampling_ratio
    pos = start[..., None, None] + (i[:, None] + s[None, :]) * bin_size[..., None, None]
    valid = (pos >= -1.0) & (pos <= in_size)
    pos = pos.clamp(min=0.0)
    low = torch.floor(pos)
    at_edge = low >= in_size - 1
    low = torch.where(at_edge, torch.full_like(low, in_size - 1.0), low)
    frac = torch.where(at_edge, torch.zeros_like(pos), pos - low)
    high = torch.where(at_edge, low, low + 1.0)
    cols = torch.arange(in_size, dtype=torch.float32, device=dev)
    w = (cols == low[..., None]) * (1.0 - frac)[..., None] + (
        cols == high[..., None]) * frac[..., None]
    w = w * valid[..., None]
    return w.sum(dim=-2) / sampling_ratio


def _plain_nchw(feats, rois, output_size, spatial_scale, sampling_ratio):
    """(B, C, H, W) features -> (B, R, C, out_h, out_w), separable form."""
    if sampling_ratio < 1:
        raise ValueError("sampling_ratio must be >= 1 (the reference uses 1)")
    _, _, H, W = feats.shape
    out_h, out_w = output_size
    r = rois.to(torch.float32) * spatial_scale
    x1, y1, x2, y2 = r.unbind(-1)
    roi_w = torch.clamp(x2 - x1, min=1.0)
    roi_h = torch.clamp(y2 - y1, min=1.0)
    wy = _axis_weights(y1, roi_h / out_h, out_h, H, sampling_ratio)  # (B,R,oh,H)
    wx = _axis_weights(x1, roi_w / out_w, out_w, W, sampling_ratio)  # (B,R,ow,W)
    tmp = torch.einsum("brih,bchw->brciw", wy, feats.to(torch.float32))
    return torch.einsum("brciw,brjw->brcij", tmp, wx).to(feats.dtype)


@functools.cache
def _kernel_fn():
    """The C entry point of csrc/roi_align.cu, built and typed on first use."""
    fn = _build.load("roi_align").roi_align_forward
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch(feats, rois, output_size, spatial_scale, sampling_ratio):
    """Run the CUDA kernel: (B, C, H, W) -> (B, R, C, out_h, out_w)."""
    if sampling_ratio != 1:
        raise ValueError("the CUDA ROI-Align kernel implements sampling_ratio=1 only")
    if feats.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"roi_align kernel takes float32 or bfloat16 features, got {feats.dtype}")
    if rois.dtype != torch.float32:
        raise TypeError(f"roi_align kernel takes float32 rois, got {rois.dtype}")
    if feats.dim() != 4 or rois.dim() != 3 or rois.shape[-1] != 4:
        raise ValueError(
            f"expected features (B,C,H,W) and rois (B,R,4), got {tuple(feats.shape)} "
            f"and {tuple(rois.shape)}")
    B, C, H, W = feats.shape
    if rois.shape[0] != B:
        raise ValueError(f"rois batch {rois.shape[0]} != features batch {B}")
    if not (feats.is_cuda and rois.device == feats.device):
        raise ValueError("features and rois must lie on the same CUDA device")
    if not (feats.is_contiguous() and rois.is_contiguous()):
        raise ValueError("roi_align kernel takes contiguous features and rois")
    out_h, out_w = output_size
    R = rois.shape[1]
    out = torch.empty((B, R, C, out_h, out_w), dtype=feats.dtype, device=feats.device)
    stream = torch.cuda.current_stream(feats.device).cuda_stream
    rc = _kernel_fn()(
        feats.data_ptr(), rois.data_ptr(), out.data_ptr(),
        int(feats.dtype == torch.bfloat16), B, C, H, W, R, out_h, out_w,
        float(spatial_scale), feats.device.index or 0, stream)
    if rc != 0:
        raise RuntimeError(f"roi_align kernel launch failed with CUDA error {rc}")
    roi_align.launches += 1
    return out


def roi_align(
    features: torch.Tensor,  # (B, H, W, C)
    rois: torch.Tensor,  # (B, R, 4) [x1, y1, x2, y2]
    output_size: Tuple[int, int] = (128, 128),
    spatial_scale: float = 1.0,
    sampling_ratio: int = 1,
    dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """ROI-Align. Returns (B, R, out_h, out_w, C): the CUDA kernel for a
    CUDA tensor, the plain form for a CPU tensor."""
    feats = features.permute(0, 3, 1, 2)
    if dtype is not None:
        feats = feats.to(dtype)
    if feats.device.type == "cuda":
        out = _launch(feats.contiguous(), rois.to(torch.float32).contiguous(),
                      output_size, spatial_scale, sampling_ratio)
    elif feats.device.type == "cpu":
        out = _plain_nchw(feats, rois, output_size, spatial_scale, sampling_ratio)
    else:
        raise ValueError(f"roi_align runs on cuda or cpu, not {feats.device}")
    return out.permute(0, 1, 3, 4, 2)


roi_align.launches = 0


def roi_align_plain(
    features: torch.Tensor,
    rois: torch.Tensor,
    output_size: Tuple[int, int] = (128, 128),
    spatial_scale: float = 1.0,
    sampling_ratio: int = 1,
    dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """The plain PyTorch form of ``roi_align`` on any device, same layout."""
    feats = features.permute(0, 3, 1, 2)
    if dtype is not None:
        feats = feats.to(dtype)
    out = _plain_nchw(feats, rois, output_size, spatial_scale, sampling_ratio)
    return out.permute(0, 1, 3, 4, 2)

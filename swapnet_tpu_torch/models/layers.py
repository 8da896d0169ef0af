"""Layer library in NCHW, counterpart of ``swapnet_tpu/models/layers.py``.

Only the plain forms are ported.  The JAX package's TPU layout forms
(``Conv(impl="s2d_in")``, ``ConvTranspose(impl="s2d")``, the scatter form
of the transposed conv, ``_HeadS2D``) compute the same functions and share
these parameter trees, so the port's plain forms are held against them in
the tests.

Parameters are stored float32; ``dtype`` is the compute type, as in the
JAX package.  Submodule names follow the Flax names (``Conv_0``,
``ConvTranspose_0``, ``BatchNorm_0``, ...) so that each parameter has an
obvious counterpart and ``utils/from_jax.py`` can map them by path.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from swapnet_tpu_torch.models.initializers import make_initializer


def generator_or_default(generator: Optional[torch.Generator]) -> torch.Generator:
    """``generator``, or a CPU generator seeded with 0."""
    return generator if generator is not None else torch.Generator().manual_seed(0)


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm2d(affine=False) on NCHW (``layers.py::instance_norm``).

    float32 input takes the exact two-pass statistics.  A lower-precision
    input takes single-pass E[x^2] - E[x]^2 statistics accumulated in
    float32, with the elementwise math in the input's type, as the JAX
    package does.
    """
    if x.dtype == torch.float32:
        mean = x.mean(dim=(2, 3), keepdim=True)
        var = (x - mean).square().mean(dim=(2, 3), keepdim=True)
        return (x - mean) * torch.rsqrt(var + eps)
    x32 = x.float()
    mean32 = x32.mean(dim=(2, 3), keepdim=True)
    sq32 = x32.square().mean(dim=(2, 3), keepdim=True)
    var32 = torch.clamp(sq32 - mean32.square(), min=0.0)
    scale = torch.rsqrt(var32 + eps).to(x.dtype)
    return (x - mean32.to(x.dtype)) * scale


def leaky_relu(x: torch.Tensor, slope: float = 0.2) -> torch.Tensor:
    return torch.where(x >= 0, x, slope * x)


def upsample_nearest(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Integer nearest-neighbour upsample of H and W."""
    return x.repeat_interleave(factor, dim=2).repeat_interleave(factor, dim=3)


def resize_nearest(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Nearest resize with floor indexing, src = dst * in // out: torch's
    ``nearest`` mode (not ``nearest-exact``)."""
    ih, iw = x.shape[2], x.shape[3]
    if (ih, iw) == (out_h, out_w):
        return x
    ridx = torch.arange(out_h, device=x.device) * ih // out_h
    cidx = torch.arange(out_w, device=x.device) * iw // out_w
    return x.index_select(2, ridx).index_select(3, cidx)


def reflect_pad(x: torch.Tensor, pad: int = 1) -> torch.Tensor:
    return F.pad(x, (pad, pad, pad, pad), mode="reflect")


class Conv(nn.Module):
    """nn.Conv2d(in_ch, features, kernel_size, stride, padding) computed in
    ``dtype``; weight (O, I, kh, kw), bias (O,)."""

    def __init__(self, in_ch: int, features: int, kernel_size: int = 4, stride: int = 1,
                 padding: int = 0, use_bias: bool = True, init_type: str = "kaiming",
                 init_gain: float = 0.02, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.stride, self.padding, self.dtype = stride, padding, dtype
        self.weight = nn.Parameter(torch.empty(features, in_ch, kernel_size, kernel_size))
        make_initializer(init_type, init_gain)(self.weight, generator_or_default(generator))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(x.to(self.dtype), self.weight.to(self.dtype), bias,
                        self.stride, self.padding)


class ConvTranspose(nn.Module):
    """nn.ConvTranspose2d(in_ch, features, kernel_size, stride, padding)
    computed in ``dtype``; weight in torch's (I, O, kh, kw) layout.  The JAX
    package stores the same kernel spatially pre-flipped as HWOI."""

    def __init__(self, in_ch: int, features: int, kernel_size: int = 4, stride: int = 2,
                 padding: int = 1, use_bias: bool = True, init_type: str = "kaiming",
                 init_gain: float = 0.02, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.stride, self.padding, self.dtype = stride, padding, dtype
        self.weight = nn.Parameter(torch.empty(in_ch, features, kernel_size, kernel_size))
        make_initializer(init_type, init_gain)(self.weight, generator_or_default(generator))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv_transpose2d(x.to(self.dtype), self.weight.to(self.dtype), bias,
                                  self.stride, self.padding)


class Norm(nn.Module):
    """batch | instance | none normalization.

    Batch norm is torch's BatchNorm2d (eps 1e-5, momentum 0.1, which is
    Flax's 0.9), scale ~ N(1, init_gain), computed in float32 and returned
    in the input's type as Flax does with float32 parameters.
    """

    def __init__(self, norm_type: str = "instance", channels: int = 0,
                 init_gain: float = 0.02, generator: Optional[torch.Generator] = None):
        super().__init__()
        if norm_type not in ("instance", "batch", "none"):
            raise NotImplementedError(f"normalization layer [{norm_type}] is not found")
        self.norm_type = norm_type
        if norm_type == "batch":
            self.BatchNorm_0 = nn.BatchNorm2d(channels, eps=1e-5, momentum=0.1)
            with torch.no_grad():
                self.BatchNorm_0.weight.normal_(
                    1.0, init_gain, generator=generator_or_default(generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.norm_type == "instance":
            return instance_norm(x)
        if self.norm_type == "batch":
            return self.BatchNorm_0(x.float()).to(x.dtype)
        return x


class UNetDown(nn.Module):
    """Conv4s2p1(no bias) -> [InstanceNorm] -> LeakyReLU(0.2) -> [Dropout]."""

    def __init__(self, in_ch: int, out_ch: int, normalize: bool = True, dropout: float = 0.0,
                 init_type: str = "kaiming", init_gain: float = 0.02,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.normalize = normalize
        self.Conv_0 = Conv(in_ch, out_ch, 4, 2, 1, use_bias=False, init_type=init_type,
                           init_gain=init_gain, dtype=dtype, generator=generator)
        self.dropout = nn.Dropout(dropout) if dropout else nn.Identity()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.Conv_0(x)
        if self.normalize:
            x = instance_norm(x)
        return self.dropout(leaky_relu(x, 0.2))


class UNetUp(nn.Module):
    """ConvT4s2p1(no bias) -> InstanceNorm -> ReLU -> [Dropout]; cat skip."""

    def __init__(self, in_ch: int, out_ch: int, dropout: float = 0.0,
                 init_type: str = "kaiming", init_gain: float = 0.02,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.ConvTranspose_0 = ConvTranspose(
            in_ch, out_ch, 4, 2, 1, use_bias=False, init_type=init_type,
            init_gain=init_gain, dtype=dtype, generator=generator)
        self.dropout = nn.Dropout(dropout) if dropout else nn.Identity()

    def forward(self, x: torch.Tensor, skip: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.dropout(torch.relu(instance_norm(self.ConvTranspose_0(x))))
        return x if skip is None else torch.cat([x, skip], dim=1)


class DualUNetUp(nn.Module):
    """UNetUp with two skip connections."""

    def __init__(self, in_ch: int, out_ch: int, dropout: float = 0.0,
                 init_type: str = "kaiming", init_gain: float = 0.02,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.UNetUp_0 = UNetUp(in_ch, out_ch, dropout, init_type, init_gain, dtype, generator)

    def forward(self, x, skip1, skip2):
        return torch.cat([self.UNetUp_0(x), skip1, skip2], dim=1)


class ResidualBlock(nn.Module):
    """(ReflectPad1 -> Conv3 -> IN -> ReLU -> Dropout) -> ReflectPad1 ->
    Conv3 -> IN, plus identity."""

    def __init__(self, ch: int, dropout: float = 0.0, init_type: str = "kaiming",
                 init_gain: float = 0.02, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        kw = dict(kernel_size=3, stride=1, padding=0, use_bias=True, init_type=init_type,
                  init_gain=init_gain, dtype=dtype, generator=generator)
        self.Conv_0 = Conv(ch, ch, **kw)
        self.Conv_1 = Conv(ch, ch, **kw)
        self.dropout = nn.Dropout(dropout) if dropout else nn.Identity()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.dropout(torch.relu(instance_norm(self.Conv_0(reflect_pad(x)))))
        y = instance_norm(self.Conv_1(reflect_pad(y)))
        return x + y


class UpsamplePadConvTanh(nn.Module):
    """Upsample(2x nearest) -> ZeroPad(left 1, top 1) -> Conv4p1 -> Tanh.

    The JAX default ``impl="s2d"`` (``_HeadS2D``) computes the same function
    from the same ``Conv_0`` kernel [4,4,C,O] and bias."""

    def __init__(self, in_ch: int, out_ch: int, init_type: str = "kaiming",
                 init_gain: float = 0.02, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.Conv_0 = Conv(in_ch, out_ch, 4, 1, 1, use_bias=True, init_type=init_type,
                           init_gain=init_gain, dtype=dtype, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.pad(upsample_nearest(x, 2), (1, 0, 1, 0))
        return torch.tanh(self.Conv_0(x))

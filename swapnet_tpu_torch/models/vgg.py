"""VGG16 feature extractor for the perceptual loss, counterpart of
``swapnet_tpu/models/vgg.py::VGG16Features``.

torchvision ``vgg16().features``: 13 3x3 convs + ReLU and 4 max pools, cut
into the 5 taps before each pool (relu1_2, relu2_2, relu3_3, relu4_3,
relu5_3).  Every conv is ``ops/conv3x3.py::conv3x3_bias_act``: the CUDA
kernel on the card, its plain form on the CPU.

Layout: the input (B, H, W, 3) and every activation and tap are
channels-last, the kernel's layout, so the only conversion is the caller's
at the input.  Parameters are float32, named ``conv{b}_{c}``, each a weight
(O, I, 3, 3) and a bias (O,); ``dtype`` is the compute type.

The JAX package's ``block1_s2d`` (width-packed block 1, tap 1 returned
phase-packed) and ``conv_impl`` choices compute the same function over the
same parameters; the port runs the plain unpacked math.
"""

from __future__ import annotations

import math
from typing import Dict, List, Mapping, Optional

import torch
import torch.nn as nn

from swapnet_tpu_torch.models.layers import generator_or_default
from swapnet_tpu_torch.ops.conv3x3 import conv3x3_bias_act
from swapnet_tpu_torch.ops.pooling import max_pool_2x2

# torchvision vgg16 conv output channels per block
CFG = [(2, 64), (2, 128), (3, 256), (3, 512), (3, 512)]
# torchvision ``features`` indices of the 13 convs
TORCHVISION_CONV_IDX = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]


class Conv3x3(nn.Module):
    """3x3 pad-1 conv + bias + ReLU on channels-last maps.  Init as Flax's
    ``lecun_normal`` (a normal truncated at two standard deviations, scaled
    to variance 1 / fan_in) and zero bias."""

    def __init__(self, in_ch: int, features: int, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(features, in_ch, 3, 3))
        self.bias = nn.Parameter(torch.zeros(features))
        # flax's truncated normal: std 1 / sqrt(fan_in), corrected for the cut
        std = math.sqrt(1.0 / (9 * in_ch)) / 0.87962566103423978
        with torch.no_grad():
            nn.init.trunc_normal_(self.weight, 0.0, std, -2 * std, 2 * std,
                                  generator=generator_or_default(generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv3x3_bias_act(x.to(self.dtype), self.weight, self.bias, relu=True)


class VGG16Features(nn.Module):
    """Returns the 5 tap activations (one per conv block, before its pool)."""

    def __init__(self, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator_or_default(generator)
        self.dtype = dtype
        in_ch = 3
        for b, (n_convs, ch) in enumerate(CFG):
            for c in range(n_convs):
                self.add_module(f"conv{b + 1}_{c + 1}", Conv3x3(in_ch, ch, dtype, g))
                in_ch = ch

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x (B, H, W, 3) -> 5 taps (B, H/2^b, W/2^b, C_b), channels-last."""
        taps = []
        h = x.to(self.dtype).contiguous()
        for b, (n_convs, _) in enumerate(CFG):
            if b > 0:
                h = max_pool_2x2(h)
            for c in range(n_convs):
                h = self.get_submodule(f"conv{b + 1}_{c + 1}")(h)
            taps.append(h)
        return taps


def vgg16_state_dict_from_torchvision(sd: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A torchvision ``vgg16`` state dict (``features.{idx}.weight/.bias``,
    OIHW) as ``VGG16Features``'s state dict; counterpart of
    ``load_torch_vgg16_features``.  Classifier entries are ignored."""
    out = {}
    names = [f"conv{b + 1}_{c + 1}" for b, (n, _) in enumerate(CFG) for c in range(n)]
    for name, idx in zip(names, TORCHVISION_CONV_IDX):
        out[f"{name}.weight"] = sd[f"features.{idx}.weight"].detach().float().clone()
        out[f"{name}.bias"] = sd[f"features.{idx}.bias"].detach().float().clone()
    return out

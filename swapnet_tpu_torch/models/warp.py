"""WarpModule in NCHW, counterpart of ``swapnet_tpu/models/warp.py``.

body encoder : 4 x UNetDown (body_ch -> 64 -> 128 -> 256 -> 512)
cloth encoder: 6 x UNetDown (cloth_ch -> ... -> 1024), 2 x UNetUp (-> 512)
bottleneck   : cat(body_d4, cloth_u2) = 1024 ch -> 4 x ResidualBlock
decoder      : 3 x DualUNetUp with skips from both encoders
head         : Upsample2x -> ZeroPad(1,0,1,0) -> Conv4 -> Tanh -> cloth_ch

The JAX default ``head_impl="s2d"`` is the same head as one space-to-depth
conv over the same parameters; the port keeps the plain form.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from swapnet_tpu_torch.models.layers import (
    DualUNetUp, ResidualBlock, UNetDown, UNetUp, UpsamplePadConvTanh, generator_or_default)


class WarpModule(nn.Module):
    def __init__(self, body_channels: int = 3, cloth_channels: int = 19, dropout: float = 0.5,
                 init_type: str = "kaiming", init_gain: float = 0.02,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator_or_default(generator)
        self.body_channels, self.cloth_channels = body_channels, cloth_channels
        self.dtype = dtype
        kw = dict(init_type=init_type, init_gain=init_gain, dtype=dtype, generator=g)
        # (in, out, normalize, dropout) per UNetDown, in the JAX creation order
        downs = [
            (body_channels, 64, False, 0.0), (64, 128, True, 0.0),
            (128, 256, True, 0.0), (256, 512, True, dropout),
            (cloth_channels, 64, False, 0.0), (64, 128, True, 0.0),
            (128, 256, True, 0.0), (256, 512, True, 0.0),
            (512, 1024, True, dropout), (1024, 1024, False, dropout),
        ]
        for k, (cin, cout, norm, drop) in enumerate(downs):
            self.add_module(f"UNetDown_{k}", UNetDown(cin, cout, norm, drop, **kw))
        self.UNetUp_0 = UNetUp(1024, 1024, **kw)
        self.UNetUp_1 = UNetUp(1024, 512, **kw)
        for k in range(4):
            self.add_module(f"ResidualBlock_{k}", ResidualBlock(1024, dropout, **kw))
        self.DualUNetUp_0 = DualUNetUp(1024, 256, **kw)
        self.DualUNetUp_1 = DualUNetUp(768, 128, **kw)
        self.DualUNetUp_2 = DualUNetUp(384, 64, **kw)
        self.UpsamplePadConvTanh_0 = UpsamplePadConvTanh(192, cloth_channels, **kw)

    def forward(self, body: torch.Tensor, cloth: torch.Tensor) -> torch.Tensor:
        """body (B, body_ch, H, W), cloth (B, cloth_ch, H, W) -> (B, cloth_ch, H, W)."""
        if min(body.shape[2], body.shape[3]) < 64:
            # six halvings of the cloth encoder leave nothing below 64
            raise ValueError(f"WarpModule needs height/width >= 64, got {tuple(body.shape[2:])}")
        d = [self.get_submodule(f"UNetDown_{k}") for k in range(10)]
        body = body.to(self.dtype)
        cloth = cloth.to(self.dtype)
        body_d1 = d[0](body)
        body_d2 = d[1](body_d1)
        body_d3 = d[2](body_d2)
        body_d4 = d[3](body_d3)
        cloth_d1 = d[4](cloth)
        cloth_d2 = d[5](cloth_d1)
        cloth_d3 = d[6](cloth_d2)
        cloth_d4 = d[7](cloth_d3)
        cloth_d5 = d[8](cloth_d4)
        cloth_d6 = d[9](cloth_d5)
        cloth_u2 = self.UNetUp_1(self.UNetUp_0(cloth_d6))
        x = torch.cat([body_d4, cloth_u2], dim=1)
        for k in range(4):
            x = self.get_submodule(f"ResidualBlock_{k}")(x)
        x = self.DualUNetUp_0(x, body_d3, cloth_d3)
        x = self.DualUNetUp_1(x, body_d2, cloth_d2)
        x = self.DualUNetUp_2(x, body_d1, cloth_d1)
        return self.UpsamplePadConvTanh_0(x)

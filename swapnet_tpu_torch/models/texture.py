"""TextureModule in NCHW, counterpart of ``swapnet_tpu/models/texture.py``.

1. ROI-Align the R body boxes from the input texture to (roi, roi): the
   CUDA kernel on the card, the plain form on the CPU.
2. Pooled ROIs become channels in ROI-major then RGB order: the kernel's
   (B, R, C, h, w) output viewed as (B, R*C, h, w).
3. UNetDown(R*C -> R*C), nearest-resize back to H x W, concat the cloth
   segmentation, then the pix2pix UnetGenerator with log2(img_size) downs.

The JAX default ``fuse_l0=True`` runs step 3's first conv in split form
without the resize; it is the same function as the plain form kept here.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from swapnet_tpu_torch.models.layers import UNetDown, generator_or_default, resize_nearest
from swapnet_tpu_torch.models.unet import UnetGenerator
from swapnet_tpu_torch.ops.roi_align import roi_align


class TextureModule(nn.Module):
    def __init__(self, texture_channels: int = 3, cloth_channels: int = 19, num_roi: int = 12,
                 norm_type: str = "batch", dropout: float = 0.5, img_size: int = 128,
                 roi_size: int = 128, init_type: str = "kaiming", init_gain: float = 0.02,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator_or_default(generator)
        self.texture_channels, self.cloth_channels = texture_channels, cloth_channels
        self.num_roi, self.img_size, self.roi_size = num_roi, img_size, roi_size
        self.dtype = dtype
        kw = dict(init_type=init_type, init_gain=init_gain, dtype=dtype, generator=g)
        pooled_ch = num_roi * texture_channels
        self.UNetDown_0 = UNetDown(pooled_ch, pooled_ch, **kw)
        self.UnetGenerator_0 = UnetGenerator(
            pooled_ch + cloth_channels, output_nc=texture_channels,
            num_downs=img_size.bit_length() - 1, norm_type=norm_type,
            use_dropout=bool(dropout), **kw)

    def forward(
        self,
        input_tex: torch.Tensor,  # (B, texture_channels, H, W)
        rois: torch.Tensor,  # (B, num_roi, 4) [x1, y1, x2, y2]
        cloth: torch.Tensor,  # (B, cloth_channels, H, W)
    ) -> torch.Tensor:
        B, C, H, W = input_tex.shape
        pooled = roi_align(input_tex.permute(0, 2, 3, 1), rois,
                           output_size=(self.roi_size, self.roi_size), dtype=self.dtype)
        # (B, R, h, w, C) is a view of the (B, R, C, h, w) result
        pooled = pooled.permute(0, 1, 4, 2, 3).reshape(
            B, self.num_roi * C, self.roi_size, self.roi_size)
        encoded = self.UNetDown_0(pooled)
        upsampled = resize_nearest(encoded, H, W)
        return self.UnetGenerator_0(torch.cat([upsampled, cloth.to(upsampled.dtype)], dim=1))

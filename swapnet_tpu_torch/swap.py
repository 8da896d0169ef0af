"""Fused two-stage swap, counterpart of ``swapnet_tpu/swap.py``.

    warped = WarpModule(body, cloth)
    onehot = one_hot(argmax(warped))     # the npz interchange, on the device
    out    = TextureModule(texture, rois, onehot)

Both generators run in eval mode.  Their weights live on the device, and
the conv weights are held in the compute type once at build time (the JAX
package casts them to it on every call; the result is the same).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from swapnet_tpu_torch.data.codec import labels_to_onehot
from swapnet_tpu_torch.device import DeviceLike, resolve_device
from swapnet_tpu_torch.models.layers import Conv, ConvTranspose
from swapnet_tpu_torch.models.texture import TextureModule
from swapnet_tpu_torch.models.warp import WarpModule


def _place(module: nn.Module, device: torch.device) -> nn.Module:
    module = module.to(device).eval()
    for sub in module.modules():
        if isinstance(sub, (Conv, ConvTranspose)):
            sub.to(sub.dtype)
    return module


class FusedSwap:
    """Holds the two generators on ``device`` and runs the swap."""

    def __init__(self, warp_module: WarpModule, texture_module: TextureModule,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.warp = _place(warp_module, self.device)
        self.texture = _place(texture_module, self.device)

    @torch.inference_mode()
    def __call__(self, body, cloth, texture, rois):
        """body (B,3,H,W) normalised, cloth (B,19,H,W) one-hot, texture
        (B,3,H,W) normalised, rois (B,12,4) -> (B,3,H,W) in [-1, 1]."""
        warped = self.warp(body, cloth)
        onehot = labels_to_onehot(warped.argmax(dim=1), warped.shape[1], dtype=warped.dtype)
        return self.texture(texture, rois, onehot)

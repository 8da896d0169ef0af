"""Serving: the fused swap built from checkpoint directories, counterpart of
``swapnet_tpu/serving.py`` (``build_fused_swap`` and ``SwapService``).

``SwapService`` takes uint8 in and gives uint8 out in the JAX package's
layout.  Per swap there is one upload (all inputs packed into one host
buffer) and one download; normalisation, one-hot, the swap and the
[-1, 1] -> uint8 decode (clip, x255, round half to even) run on the device.

The JAX export path (``export_service``, ``ExportedSwapService``) is not
ported yet.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from swapnet_tpu_torch.data.codec import labels_to_onehot
from swapnet_tpu_torch.data.transforms import normalize
from swapnet_tpu_torch.device import DeviceLike, resolve_device
from swapnet_tpu_torch.models.texture import TextureModule
from swapnet_tpu_torch.models.warp import WarpModule
from swapnet_tpu_torch.swap import FusedSwap
from swapnet_tpu_torch.utils.checkpoint import load_generator_weights
from swapnet_tpu_torch.utils.from_jax import load_from_jax


def _load_args(ckpt_dir: str) -> dict:
    with open(os.path.join(ckpt_dir, "args.json")) as f:
        return json.load(f)


def _load(module: torch.nn.Module, ckpt_dir: str, label: str) -> torch.nn.Module:
    params, extra = load_generator_weights(ckpt_dir, label)
    return load_from_jax(module, {"params": params, **(extra or {})})


def build_fused_swap(
    warp_ckpt_dir: str,
    texture_ckpt_dir: str,
    load_epoch: str = "latest",
    dtype: torch.dtype = torch.bfloat16,
    device: DeviceLike = None,
) -> Tuple[FusedSwap, dict]:
    """(FusedSwap, texture args dict) from two checkpoint directories."""
    device = resolve_device(device)
    wargs = _load_args(warp_ckpt_dir)
    targs = _load_args(texture_ckpt_dir)
    netG = targs.get("netG", "swapnet")
    if netG != "swapnet":
        raise ValueError(
            f"fused swap requires a TextureModule checkpoint (netG='swapnet'); "
            f"this checkpoint was trained with netG='{netG}'")
    body_channels = wargs["body_channels"] if wargs["body_representation"] == "labels" else 3
    cloth_channels = wargs["cloth_channels"] if wargs["cloth_representation"] == "labels" else 3
    with torch.device("meta"):  # the checkpoint supplies every weight
        warp = WarpModule(body_channels=body_channels, cloth_channels=cloth_channels,
                          dtype=dtype)
        tex = TextureModule(
            texture_channels=targs["texture_channels"],
            cloth_channels=targs["cloth_channels"],
            num_roi=targs["body_channels"],
            img_size=targs["crop_size"],
            norm_type=targs.get("norm", "instance"),
            dtype=dtype,
        )
    _load(warp, warp_ckpt_dir, load_epoch)
    _load(tex, texture_ckpt_dir, load_epoch)
    return FusedSwap(warp, tex, device), targs


class SwapService:
    """uint8-in / uint8-out wrapper around a FusedSwap."""

    def __init__(self, fused: FusedSwap, body_norm_stats: Tuple[Sequence[float], Sequence[float]],
                 texture_norm_stats: Tuple[Sequence[float], Sequence[float]],
                 cloth_channels: Optional[int] = None):
        self.fused = fused
        self.body_stats = body_norm_stats
        self.texture_stats = texture_norm_stats
        self.cloth_channels = cloth_channels or fused.warp.cloth_channels

    def _upload(self, body_u8, cloth_labels, texture_u8, rois):
        """One host-to-device copy of all four inputs, split on the device."""
        rois = np.ascontiguousarray(rois, dtype=np.float32)
        parts = [np.ascontiguousarray(a, dtype=np.uint8) for a in (body_u8, cloth_labels, texture_u8)]
        host = np.concatenate([rois.reshape(-1).view(np.uint8)] + [p.reshape(-1) for p in parts])
        dev = torch.from_numpy(host).to(self.fused.device)
        out, offset = [dev[:rois.nbytes].view(torch.float32).view(rois.shape)], rois.nbytes
        for p in parts:
            out.append(dev[offset:offset + p.size].view(p.shape))
            offset += p.size
        return out

    @torch.inference_mode()
    def swap_async(self, body_u8, cloth_labels, texture_u8, rois) -> torch.Tensor:
        """Dispatch one swap; returns the (B,H,W,3) uint8 result on the
        device without waiting for it (``.cpu()`` fetches it)."""
        rois_d, body_d, labels_d, tex_d = self._upload(body_u8, cloth_labels, texture_u8, rois)
        body = normalize(body_d.permute(0, 3, 1, 2).float() / 255.0, *self.body_stats)
        cloth = labels_to_onehot(labels_d, self.cloth_channels)
        texture = normalize(tex_d.permute(0, 3, 1, 2).float() / 255.0, *self.texture_stats)
        out = self.fused(body, cloth, texture, rois_d)
        out = torch.clamp((out.float() + 1.0) / 2.0, 0.0, 1.0)
        return torch.round(out * 255.0).to(torch.uint8).permute(0, 2, 3, 1).contiguous()

    def swap(
        self,
        body_u8: np.ndarray,  # (B, H, W, 3) uint8 body segmentation RGB
        cloth_labels: np.ndarray,  # (B, H, W) uint8 label map
        texture_u8: np.ndarray,  # (B, H, W, 3) uint8 source photo
        rois: np.ndarray,  # (B, 12, 4)
    ) -> np.ndarray:
        return self.swap_async(body_u8, cloth_labels, texture_u8, rois).cpu().numpy()

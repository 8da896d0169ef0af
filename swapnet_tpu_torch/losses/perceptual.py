"""VGG16 perceptual (content + style) loss, counterpart of
``swapnet_tpu/losses/perceptual.py``.

* Images (B, 3, H, W) in [0, 1] are mapped to [-1, 1] and turned
  channels-last once for the VGG; the taps stay channels-last, so the
  channel reductions run over the last axis as in the JAX package.
* Content: the mean squared distance between the channel-normalised taps,
  summed over the 5 taps, in the JAX default cosine form with eps^2 inside
  the rsqrt; ``compat_eps_outside`` normalises as the reference does,
  x / (|x| + 1e-8).
* Style: with ``compat_image_gram`` (the texture stage's default) the
  reference's gram of the raw *images*, once per tap; otherwise grams of the
  tap features.
* The target taps carry no gradient: the VGG runs on the targets under
  ``torch.no_grad()``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Tuple

import torch

_EPS2 = 1e-8 ** 2


@dataclasses.dataclass(frozen=True)
class PerceptualLossConfig:
    normalize: bool = True
    use_style: bool = False
    compat_image_gram: bool = False
    compat_eps_outside: bool = False


def _gram(x: torch.Tensor) -> torch.Tensor:
    """(B*C, B*C) gram of a (B, C, H, W) map over its flattened (H, W), with
    float32 sums: the reference's ``gram_matrix``."""
    B, C = x.shape[:2]
    flat = x.reshape(B * C, -1).float()
    return flat @ flat.T


def _normalized_mse(o: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """mean of (o_hat - t_hat)^2 with o_hat = o * rsqrt(sum_c o^2 + eps^2),
    from three float32 channel sums (no normalised tensor is written)."""
    o32, t32 = o.float(), t.float()
    so = o32.square().sum(-1)
    st = t32.square().sum(-1)
    ot = (o32 * t32).sum(-1)
    den_o, den_t = so + _EPS2, st + _EPS2
    per_pixel = so / den_o + st / den_t - 2.0 * ot * torch.rsqrt(den_o * den_t)
    return per_pixel.mean() / o.shape[-1]


def perceptual_loss(
    vgg: Callable[[torch.Tensor], List[torch.Tensor]],  # (B, H, W, 3) -> taps
    output: torch.Tensor,  # (B, 3, H, W) generated image
    target: torch.Tensor,  # (B, 3, H, W) ground truth
    cfg: PerceptualLossConfig = PerceptualLossConfig(),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (content_loss, style_loss) float32 scalars."""
    out_f = vgg((2.0 * output - 1.0).permute(0, 2, 3, 1))
    with torch.no_grad():
        tgt_f = vgg((2.0 * target - 1.0).permute(0, 2, 3, 1))
    dev = output.device
    content = torch.zeros((), device=dev)
    style = torch.zeros((), device=dev)
    if cfg.use_style and cfg.compat_image_gram:
        with torch.no_grad():
            gram_t = _gram(target)
        image_style = (_gram(output) - gram_t).square().mean()
    for o, t in zip(out_f, tgt_f):
        if cfg.normalize and cfg.compat_eps_outside:
            o32, t32 = o.float(), t.float()
            o_hat = o32 / (o32.square().sum(-1, keepdim=True).sqrt() + 1e-8)
            t_hat = t32 / (t32.square().sum(-1, keepdim=True).sqrt() + 1e-8)
            content = content + (o_hat - t_hat).square().mean()
        elif cfg.normalize:
            content = content + _normalized_mse(o, t)
        else:
            content = content + (o.float() - t.float()).square().mean()
        if cfg.use_style:
            if cfg.compat_image_gram:
                style = style + image_style
            else:
                go, gt = _gram(o.permute(0, 3, 1, 2)), _gram(t.permute(0, 3, 1, 2))
                style = style + (go - gt).square().mean()
    return content, style

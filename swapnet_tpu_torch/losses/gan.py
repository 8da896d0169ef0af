"""Adversarial losses, counterpart of ``swapnet_tpu/losses/gan.py``.

Modes ``vanilla`` (BCE with logits), ``lsgan`` (MSE) and ``wgan`` (+/- mean).
Smooth labels (the reference default): one scalar per call, drawn from an
explicit ``torch.Generator``: real ~ U[0.7, 1.1], fake ~ U[0.0, 0.3];
``compat_fake_label_bug`` draws fake labels from the real range, as the
reference does.  The draws will not equal JAX's from the same seed; a
caller that needs a given label passes ``label``.

The penalty modes (``wgan-gp``, ``wgan-lp``, ``dragan*``, ``mescheder-*``)
and ``gradient_penalty`` are not ported yet: their configs raise.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

PORTED_MODES = ("vanilla", "lsgan", "wgan")
KNOWN_MODES = PORTED_MODES + (
    "wgan-gp", "wgan-lp", "dragan", "dragan-gp", "dragan-lp", "mescheder-r1-gp",
    "mescheder-r2-gp")


@dataclasses.dataclass(frozen=True)
class GANLossConfig:
    gan_mode: str = "vanilla"
    smooth_labels: bool = True
    real_range: tuple = (0.7, 1.1)
    fake_range: tuple = (0.0, 0.3)
    compat_fake_label_bug: bool = False

    def __post_init__(self):
        if self.gan_mode not in KNOWN_MODES:
            raise NotImplementedError(f"gan mode {self.gan_mode} not implemented")
        if self.gan_mode not in PORTED_MODES:
            raise NotImplementedError(f"gan mode {self.gan_mode} (gradient penalty) is not "
                                      "ported yet")


def gan_label(cfg: GANLossConfig, target_is_real: bool,
              generator: Optional[torch.Generator] = None,
              device: Union[str, torch.device] = "cpu") -> torch.Tensor:
    """The float32 target label: one uniform draw from ``generator`` with
    smooth labels, else 1 or 0."""
    if not cfg.smooth_labels:
        return torch.tensor(1.0 if target_is_real else 0.0, device=device)
    if generator is None:
        raise ValueError("smooth labels need an explicit torch.Generator")
    low, high = (cfg.real_range if target_is_real or cfg.compat_fake_label_bug
                 else cfg.fake_range)
    u = torch.rand((), generator=generator, device=generator.device)
    return (u * (high - low) + low).to(device)


def gan_loss(prediction: torch.Tensor, target_is_real: bool, cfg: GANLossConfig,
             generator: Optional[torch.Generator] = None,
             label: Optional[Union[float, torch.Tensor]] = None) -> torch.Tensor:
    """Scalar float32 adversarial loss for a discriminator prediction map."""
    pred = prediction.float()
    if "wgan" in cfg.gan_mode:
        return -pred.mean() if target_is_real else pred.mean()
    target = (gan_label(cfg, target_is_real, generator, pred.device) if label is None
              else torch.as_tensor(label, dtype=torch.float32, device=pred.device))
    if cfg.gan_mode == "lsgan":
        return (pred - target).square().mean()
    # the stable log-sigmoid form of BCE with logits, as the JAX package writes it
    return (torch.clamp(pred, min=0) - pred * target + torch.log1p(torch.exp(-pred.abs()))).mean()

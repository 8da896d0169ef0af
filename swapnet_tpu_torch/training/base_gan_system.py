"""BaseGANSystem, counterpart of ``swapnet_tpu/training/base_gan_system.py``.

``train_step(state, batch) -> (state, metrics)`` runs the JAX package's
fused step in the same order (``:152-233``):

  1. one generator forward, whose graph is kept for the generator backward;
  2. the discriminator update on (detached fakes, targets), each joined with
     the conditioning input: loss 0.5 * (fake + real) * lambda_D, then the D
     optimizer step (wgan clamps D's weights first);
  3. the generator loss against the *updated* discriminator:
     ``torch.autograd.grad(loss_G, fakes)`` on a detached copy of the fakes,
     so D's parameters collect nothing from it;
  4. ``fakes.backward(fakes_grad)`` into G, then the G optimizer step.

D's in-place update comes before the G-side D forward, so no saved tensor
of a later graph is changed under it.  Every random number of a step
(dropout masks, smooth labels) comes from ``state.rng`` in that order.
The modules and optimizers are updated in place; the same state is
returned.  Subclasses provide the model hooks.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from swapnet_tpu_torch.losses.gan import GANLossConfig, gan_loss
from swapnet_tpu_torch.training.optimizers import OptimizerConfig
from swapnet_tpu_torch.training.state import GANTrainState

Batch = Dict[str, torch.Tensor]


class BaseGANSystem:
    def __init__(
        self,
        gan_cfg: GANLossConfig = GANLossConfig(),
        g_opt: OptimizerConfig = OptimizerConfig(lr=1e-4),
        d_opt: OptimizerConfig = OptimizerConfig(lr=4e-4, weight_decay=0.01),
        lambda_gan: float = 1.0,
        lambda_discriminator: float = 1.0,
        lambda_gp: float = 10.0,
        wgan_clamp: bool = True,
    ):
        self.gan_cfg = gan_cfg
        self.g_opt_cfg, self.d_opt_cfg = g_opt, d_opt
        self.lambda_gan = lambda_gan
        self.lambda_discriminator = lambda_discriminator
        self.lambda_gp = lambda_gp  # for the penalty modes, not ported yet
        self.gan_mode = gan_cfg.gan_mode
        # as in the JAX package, wgan really clamps D (the reference's clamp
        # is a no-op); wgan_clamp=False reproduces the reference
        self.wgan_clamp = wgan_clamp

    # ---- model-specific hooks -------------------------------------------

    def generator_forward(self, state: GANTrainState, batch: Batch) -> torch.Tensor:
        raise NotImplementedError

    def d_condition(self, batch: Batch, img: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def targets(self, batch: Batch) -> torch.Tensor:
        raise NotImplementedError

    def extra_g_losses(self, state: GANTrainState, fakes: torch.Tensor,
                       batch: Batch) -> Dict[str, torch.Tensor]:
        """Weighted non-adversarial generator losses, keyed by metric name."""
        return {}

    # ---- the train step ----------------------------------------------------

    def train_step(self, state: GANTrainState,
                   batch: Batch) -> Tuple[GANTrainState, Dict[str, torch.Tensor]]:
        metrics: Dict[str, torch.Tensor] = {}
        G, D, rng = state.G, state.D, state.rng
        G.train()
        fakes = self.generator_forward(state, batch)

        if D is not None:
            D.train()
            d_params = list(D.parameters())
            if self.gan_mode == "wgan" and self.wgan_clamp:
                with torch.no_grad():
                    for p in d_params:
                        p.clamp_(-0.01, 0.01)
            pred_fake = D(self.d_condition(batch, fakes.detach()))
            loss_fake = gan_loss(pred_fake, False, self.gan_cfg, rng)
            pred_real = D(self.d_condition(batch, self.targets(batch)))
            loss_real = gan_loss(pred_real, True, self.gan_cfg, rng)
            loss_d = 0.5 * (loss_fake + loss_real) * self.lambda_discriminator
            d_grads = torch.autograd.grad(loss_d, d_params)
            state.d_opt.step(d_grads)
            metrics.update(loss_D_fake=loss_fake, loss_D_real=loss_real, loss_D=loss_d)

        fakes_in = fakes.detach().requires_grad_(True)
        extra = self.extra_g_losses(state, fakes_in, batch)
        loss_g = torch.zeros((), device=fakes.device)
        for v in extra.values():
            loss_g = loss_g + v
        metrics.update(extra)
        if D is not None and self.lambda_gan:
            pred = D(self.d_condition(batch, fakes_in))
            loss_gan = gan_loss(pred, True, self.gan_cfg, rng) * self.lambda_gan
            loss_g = loss_g + loss_gan
            metrics["loss_G_gan"] = loss_gan
        metrics["loss_G"] = loss_g
        (fakes_grad,) = torch.autograd.grad(loss_g, fakes_in)
        fakes.backward(fakes_grad)
        state.g_opt.step()
        for p in G.parameters():
            p.grad = None
        state.step += 1
        return state, {k: v.detach().float() for k, v in metrics.items()}

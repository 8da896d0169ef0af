"""Optimizers, counterpart of ``swapnet_tpu/training/optimizers.py``.

``AdamW`` reproduces ``optax.adamw(lr, b1, b2, eps=1e-8, weight_decay,
mu_dtype)`` step for step, which ``torch.optim.AdamW`` cannot: the first
moment may be stored in bfloat16.  Per parameter, as optax 0.2's
``scale_by_adam`` -> ``add_decayed_weights`` -> ``scale_by_learning_rate``:

    mu  = (1 - b1) * g + b1 * mu_stored        # b1 * mu_stored in mu's type,
                                               # b1 itself rounded to it (JAX
                                               # casts a Python scalar to the
                                               # array's type: 0.8984375 in
                                               # bf16); the sum in float32
    nu  = (1 - b2) * g^2 + b2 * nu             # float32
    u   = (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps)
    p  += -lr(t - 1) * (u + wd * p)
    mu_stored = mu cast to mu_dtype

The bias-corrected update reads ``mu`` *before* the cast; only the stored
moment is rounded.  Decay is decoupled: ``wd * p`` joins the Adam direction
before the learning rate scales both.  Updates are in place.

``make_lr`` mirrors the JAX schedules (constant, linear, cosine, with a
linear warm-up).  AdaBound and Adafactor are not ported yet.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Iterable, List, Optional, Sequence, Union

import numpy as np
import torch

Schedule = Union[float, Callable[[int], float]]


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "AdamW"  # AdamW (AdaBound and Adafactor are not ported yet)
    lr: float = 1e-4
    b1: float = 0.9
    b2: float = 0.999
    weight_decay: float = 0.0
    mu_dtype: str = "bfloat16"  # bfloat16 | float32
    lr_policy: str = "constant"  # constant | linear | cosine
    warmup_steps: int = 0
    decay_steps: int = 0  # schedule horizon including warm-up


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    return lambda t: (init - end) * (1 - min(max(t, 0), steps) / steps) + end


def make_lr(cfg: OptimizerConfig) -> Schedule:
    """The learning rate: a float for a constant rate without warm-up, else
    a function of the 0-based step count."""
    if cfg.lr_policy == "constant" and not cfg.warmup_steps:
        return cfg.lr
    total = max(int(cfg.decay_steps), cfg.warmup_steps + 1)
    main_steps = max(total - cfg.warmup_steps, 1)
    if cfg.lr_policy == "constant":
        main = lambda t: cfg.lr  # noqa: E731
    elif cfg.lr_policy == "linear":
        main = _linear(cfg.lr, 0.0, main_steps)
    elif cfg.lr_policy == "cosine":
        main = lambda t: cfg.lr * 0.5 * (1 + math.cos(math.pi * min(t, main_steps) / main_steps))  # noqa: E731
    else:
        raise NotImplementedError(f"lr_policy [{cfg.lr_policy}]")
    if not cfg.warmup_steps:
        return main
    warmup = _linear(0.0, cfg.lr, cfg.warmup_steps)
    return lambda t: warmup(t) if t < cfg.warmup_steps else main(t - cfg.warmup_steps)


class AdamW:
    """optax.adamw with a ``mu_dtype`` first moment over a list of tensors."""

    def __init__(self, params: Iterable[torch.Tensor], cfg: OptimizerConfig):
        if "adam" not in cfg.name.lower():
            raise NotImplementedError(f"optimizer {cfg.name} is not ported yet")
        self.params: List[torch.Tensor] = list(params)
        self.cfg = cfg
        self.lr = make_lr(cfg)
        self.count = 0
        mu_dtype = getattr(torch, cfg.mu_dtype)
        self.mu = [torch.zeros_like(p, dtype=mu_dtype) for p in self.params]
        self._b1_mu = torch.tensor(cfg.b1, dtype=mu_dtype)  # b1 in mu's type
        self.nu = [torch.zeros_like(p, dtype=torch.float32) for p in self.params]

    @torch.no_grad()
    def step(self, grads: Optional[Sequence[Optional[torch.Tensor]]] = None) -> None:
        """One update from ``grads`` (default: each parameter's ``.grad``).
        A missing gradient counts as zero, as in optax."""
        cfg = self.cfg
        lr = self.lr(self.count) if callable(self.lr) else self.lr
        self.count += 1
        # bias corrections in float32, as optax computes b ** count
        bc1 = float(np.float32(1) - np.float32(cfg.b1) ** np.float32(self.count))
        bc2 = float(np.float32(1) - np.float32(cfg.b2) ** np.float32(self.count))
        grads = [p.grad for p in self.params] if grads is None else grads
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            g = torch.zeros_like(p) if g is None else g.float()
            m = (1 - cfg.b1) * g + mu * self._b1_mu
            nu.mul_(cfg.b2).add_((1 - cfg.b2) * g.square())
            u = (m / bc1) / ((nu / bc2).sqrt() + 1e-8)
            u = u + cfg.weight_decay * p
            p.add_(u * -lr)
            mu.copy_(m)

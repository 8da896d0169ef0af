"""Training state of a GAN system, counterpart of
``swapnet_tpu/training/state.py::GANTrainState``.

The JAX state is an immutable pytree that a jitted step consumes and
returns.  Here it holds live modules and optimizers that ``train_step``
updates in place (and returns again, so callers read the same way).  The
generator ``rng`` draws every random number of a step (dropout masks,
smooth labels) in a fixed order; the global RNG is never used.  The frozen
VGG is carried for the perceptual loss, never trained and never saved with
G.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn

from swapnet_tpu_torch.training.optimizers import AdamW


@dataclasses.dataclass
class GANTrainState:
    step: int
    rng: torch.Generator
    G: nn.Module
    g_opt: AdamW
    D: Optional[nn.Module] = None
    d_opt: Optional[AdamW] = None
    vgg: Optional[nn.Module] = None  # frozen

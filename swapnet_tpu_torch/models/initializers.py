"""Weight initializers of the reference's init families, counterpart of
``swapnet_tpu/models/initializers.py``.

normal / xavier / kaiming / orthogonal for conv weights, zeros for biases,
N(1, gain) for batch-norm scales.  Weights use torch's layouts: a conv
weight is (O, I, kh, kw) and a transposed-conv weight (I, O, kh, kw); in
both torch takes fan_in from dim 1 and fan_out from dim 0, which is what the
JAX package reproduces in its HWIO / HWOI layouts.

Draws come from an explicit ``torch.Generator`` and will not equal JAX's
draws from the same seed; tests carry weights across with
``utils/from_jax.py`` instead.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

# fills a parameter in place from a generator; a no-op on the meta device,
# so modules built there (to be loaded from a checkpoint) draw nothing
Init = Callable[[torch.Tensor, torch.Generator], None]


def _fans(t: torch.Tensor):
    rf = math.prod(t.shape[2:]) if t.dim() > 2 else 1
    return t.shape[1] * rf, t.shape[0] * rf


def normal_init(gain: float = 0.02) -> Init:
    def init(t, g):
        with torch.no_grad():
            t.normal_(0.0, gain, generator=g)

    return init


def xavier_normal_init(gain: float = 0.02) -> Init:
    def init(t, g):
        fan_in, fan_out = _fans(t)
        with torch.no_grad():
            t.normal_(0.0, gain * math.sqrt(2.0 / (fan_in + fan_out)), generator=g)

    return init


def kaiming_normal_init() -> Init:
    """kaiming_normal_(a=0, mode='fan_in', nonlinearity='leaky_relu')."""

    def init(t, g):
        fan_in, _ = _fans(t)
        with torch.no_grad():
            t.normal_(0.0, math.sqrt(2.0) / math.sqrt(fan_in), generator=g)

    return init


def orthogonal_init(gain: float = 0.02) -> Init:
    """torch's orthogonal_: rows over dim 0, the rest flattened."""

    def init(t, g):
        if t.is_meta:
            return
        with torch.no_grad():
            torch.nn.init.orthogonal_(t, gain=gain, generator=g)

    return init


def make_initializer(init_type: str, init_gain: float = 0.02) -> Init:
    if init_type == "normal":
        return normal_init(init_gain)
    if init_type == "xavier":
        return xavier_normal_init(init_gain)
    if init_type == "kaiming":
        return kaiming_normal_init()
    if init_type == "orthogonal":
        return orthogonal_init(init_gain)
    raise NotImplementedError(f"initialization method [{init_type}] is not implemented")

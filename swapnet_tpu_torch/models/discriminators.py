"""PatchGAN discriminator in NCHW, counterpart of
``swapnet_tpu/models/discriminators.py`` (``NLayerDiscriminator`` and
``define_D``).  Outputs are logit maps; the GAN loss applies the sigmoid.

Submodule names follow Flax's automatic names (``Conv_0``, ``Conv_1``, ...,
``Norm_0``, ...) so ``utils/from_jax.py`` maps parameters by path.  The
JAX package's ``quantize`` (int8 convs) and ``conv_impl="s2d_in"``
(width-packed inputs, the same function) have no counterpart here.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from swapnet_tpu_torch.models.layers import Conv, Norm, generator_or_default, leaky_relu


class NLayerDiscriminator(nn.Module):
    """70x70 PatchGAN: Conv4s2 stack of ``n_layers``, then two Conv4s1.
    Conv biases follow the norm (instance norm: bias), except the first
    and last convs, which always have one."""

    def __init__(self, input_nc: int, ndf: int = 64, n_layers: int = 3,
                 norm_type: str = "instance", init_type: str = "kaiming",
                 init_gain: float = 0.02, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator_or_default(generator)
        self.dtype = dtype
        use_bias = norm_type == "instance"
        kw = dict(init_type=init_type, init_gain=init_gain, dtype=dtype, generator=g)
        # parameters are drawn in the JAX module's creation order
        self.Conv_0 = Conv(input_nc, ndf, 4, 2, 1, use_bias=True, **kw)
        ch = ndf
        for n in range(1, n_layers):
            out = ndf * min(2 ** n, 8)
            self.add_module(f"Conv_{n}", Conv(ch, out, 4, 2, 1, use_bias=use_bias, **kw))
            self.add_module(f"Norm_{n - 1}", Norm(norm_type, out, init_gain, g))
            ch = out
        out = ndf * min(2 ** n_layers, 8)
        self.add_module(f"Conv_{n_layers}", Conv(ch, out, 4, 1, 1, use_bias=use_bias, **kw))
        self.add_module(f"Norm_{n_layers - 1}", Norm(norm_type, out, init_gain, g))
        self.add_module(f"Conv_{n_layers + 1}", Conv(out, 1, 4, 1, 1, use_bias=True, **kw))
        self.n_layers = n_layers

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = leaky_relu(self.Conv_0(x.to(self.dtype)), 0.2)
        for n in range(1, self.n_layers + 1):
            x = self.get_submodule(f"Conv_{n}")(x)
            x = leaky_relu(self.get_submodule(f"Norm_{n - 1}")(x), 0.2)
        return self.get_submodule(f"Conv_{self.n_layers + 1}")(x)


def define_D(input_nc: int, netD: str = "basic", ndf: int = 64, n_layers_D: int = 3,
             norm: str = "instance", init_type: str = "kaiming", init_gain: float = 0.02,
             dtype: torch.dtype = torch.float32,
             generator: Optional[torch.Generator] = None) -> nn.Module:
    """String factory of the reference's ``define_D``.  ``input_nc`` is
    explicit here (Flax infers it at init)."""
    if netD not in ("basic", "n_layers"):
        # "pixel" (PixelDiscriminator) is not ported yet
        raise NotImplementedError(f"Discriminator model name [{netD}] is not ported")
    return NLayerDiscriminator(input_nc, ndf, 3 if netD == "basic" else n_layers_D, norm,
                               init_type, init_gain, dtype, generator)

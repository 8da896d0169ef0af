"""pix2pix U-Net generator in NCHW, counterpart of
``swapnet_tpu/models/unet.py::UnetGenerator`` (the flat iterative form).

Level layout for num_downs=n, ngf=64 (L0 = outermost): down L0 is a conv
alone; L1..L(n-2) are lrelu, conv, norm; L(n-1) (innermost) is lrelu, conv.
The up path mirrors it, and each non-outermost level concatenates its own
down input with its up output on channels.  Conv bias iff instance norm;
the outermost up conv always has a bias.

The JAX package's ``_SplitL0Conv`` (used when it passes ``lowres``) is the
same math as upsampling and concatenating before ``down_0``; the port keeps
only that plain form, and ``down_0``'s kernel runs over
cat([upsampled, cloth]) channels in that order.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from swapnet_tpu_torch.models.layers import (
    Conv, ConvTranspose, Dropout, Norm, generator_or_default, leaky_relu)


class UnetGenerator(nn.Module):
    def __init__(self, input_nc: int, output_nc: int = 3, num_downs: int = 7, ngf: int = 64,
                 norm_type: str = "batch", use_dropout: bool = False,
                 init_type: str = "kaiming", init_gain: float = 0.02,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if num_downs < 5:
            raise ValueError("UnetGenerator needs num_downs >= 5")
        g = generator_or_default(generator)
        n = self.num_downs = num_downs
        self.dtype = dtype
        use_bias = norm_type == "instance"
        kw = dict(init_type=init_type, init_gain=init_gain, dtype=dtype, generator=g)

        def down_ch(i):
            return ngf * min(2 ** i, 8)

        # parameters are created in the JAX module's order (downs, then ups)
        for i in range(n):
            in_ch = input_nc if i == 0 else down_ch(i - 1)
            self.add_module(f"down_{i}", Conv(in_ch, down_ch(i), 4, 2, 1,
                                              use_bias=use_bias, **kw))
            if 0 < i < n - 1:
                self.add_module(f"down_norm_{i}", Norm(norm_type, down_ch(i), init_gain, g))
        for i in reversed(range(n)):
            in_ch = down_ch(i) if i == n - 1 else 2 * down_ch(i)
            out_ch = output_nc if i == 0 else down_ch(i - 1)
            self.add_module(f"up_{i}", ConvTranspose(in_ch, out_ch, 4, 2, 1,
                                                     use_bias=use_bias or i == 0, **kw))
            if i > 0:
                self.add_module(f"up_norm_{i}", Norm(norm_type, out_ch, init_gain, g))
        self.dropouts = nn.ModuleDict({
            str(i): Dropout(0.5) for i in range(4, n - 1) if use_dropout})

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``generator`` draws the dropout masks in training mode."""
        n = self.num_downs
        h = x.to(self.dtype)
        inputs = []
        for i in range(n):
            inputs.append(h)  # inputs[0] is never concatenated (outermost)
            if i > 0:
                h = leaky_relu(h, 0.2)
            h = self.get_submodule(f"down_{i}")(h)
            if 0 < i < n - 1:
                h = self.get_submodule(f"down_norm_{i}")(h)
        u = h
        for i in reversed(range(n)):
            u = self.get_submodule(f"up_{i}")(torch.relu(u))
            if i > 0:
                u = self.get_submodule(f"up_norm_{i}")(u)
                if str(i) in self.dropouts:
                    u = self.dropouts[str(i)](u, generator)
                u = torch.cat([inputs[i], u], dim=1)
        return torch.tanh(u)

"""2x2, stride-2 max pooling of channels-last maps, counterpart of
``swapnet_tpu/ops/pooling.py::max_pool_2x2``.

``F.max_pool2d`` on the channels-last view: the result stays channels-last,
and the gradient goes to the first maximal element of each window in
row-major order ((0,0), (0,1), (1,0), (1,1)), which is what the JAX
package's custom VJP reproduces from torch's ``MaxPool2d``.  Post-ReLU maps
are full of exact-zero ties, so the routing of ties matters.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) -> (B, H/2, W/2, C); H and W must be even."""
    if x.shape[1] % 2 or x.shape[2] % 2:
        raise ValueError(f"max_pool_2x2 needs even H and W, got {tuple(x.shape)}")
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)

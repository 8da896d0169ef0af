"""Normalisation: the port's own copy of ``normalize`` from
``swapnet_tpu/data/transforms.py``."""

from __future__ import annotations

from typing import Sequence

import torch


def normalize(x: torch.Tensor, mean: Sequence[float], std: Sequence[float]) -> torch.Tensor:
    """(x - mean) / std per channel of an NCHW tensor."""
    mean = torch.as_tensor(mean, dtype=x.dtype, device=x.device)[None, :, None, None]
    std = torch.as_tensor(std, dtype=x.dtype, device=x.device)[None, :, None, None]
    return (x - mean) / std

"""One-hot decode of cloth label maps: the port's own copy of
``labels_to_onehot`` from ``swapnet_tpu/data/codec.py``."""

from __future__ import annotations

import torch


def labels_to_onehot(labels: torch.Tensor, n_labels: int = 19,
                     dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B, H, W) integer labels -> (B, n_labels, H, W) one-hot (NCHW).

    Label 0 maps to channel 0, as the reference's to_onehot_tensor does for
    background."""
    eye = torch.arange(n_labels, device=labels.device, dtype=labels.dtype)
    return (labels[:, None] == eye[None, :, None, None]).to(dtype)

"""PyTorch / CUDA port of ``swapnet_tpu`` for a single NVIDIA H100.

The JAX package stays the reference; every module here names its
counterpart there.  Plain tensor code is PyTorch in NCHW; the one TPU
kernel on the serving path, ROI-Align, is a hand-written CUDA kernel
(``csrc/roi_align.cu``) built at first use.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from swapnet_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]

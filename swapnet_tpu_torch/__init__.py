"""PyTorch / CUDA port of ``swapnet_tpu`` for a single NVIDIA H100.

The JAX package stays the reference; every module here names its
counterpart there.  Plain tensor code is PyTorch in NCHW (the VGG of the
perceptual loss runs channels-last); the TPU kernels are hand-written CUDA
kernels built at first use: ROI-Align (``csrc/roi_align.cu``, serving and
training) and the VGG's 3x3 conv (``csrc/conv3x3.cu``, training).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from swapnet_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]

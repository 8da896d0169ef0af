"""TextureSystem, counterpart of ``swapnet_tpu/training/texture_system.py``:
the texture-stage GAN.

Generator: ``TextureModule`` (ROI-Align + pix2pix U-Net).  Discriminator:
the PatchGAN conditioned on the cloth map, cat(cloths, image) on channels.
G loss = GAN + L1 * lambda_l1 + VGG content * lambda_content
       + style * lambda_style, against a frozen VGG16.

Batch (NCHW, the port's layout; the JAX package's is NHWC):
  input_textures  (B, 3, H, W)   normalised input RGB
  rois            (B, 12, 4)     [x1, y1, x2, y2] per body part
  cloths          (B, 19, H, W)  one-hot cloth map
  target_textures (B, 3, H, W)   normalised target RGB

The JAX package's TPU knobs (``vgg_conv_impl``, ``vgg_block1_s2d``,
``fuse_l0``, ``up0_impl``, ``d_conv_impl``, ``pool_bwd``,
``remat_perceptual``) choose between forms of the same function; they are
accepted here and ignored, because the port runs the plain math (and every
VGG conv through its CUDA kernel on the card).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch

from swapnet_tpu_torch.device import DeviceLike, resolve_device
from swapnet_tpu_torch.losses.gan import GANLossConfig
from swapnet_tpu_torch.losses.perceptual import PerceptualLossConfig, perceptual_loss
from swapnet_tpu_torch.models.discriminators import define_D
from swapnet_tpu_torch.models.texture import TextureModule
from swapnet_tpu_torch.models.vgg import VGG16Features
from swapnet_tpu_torch.training.base_gan_system import Batch, BaseGANSystem
from swapnet_tpu_torch.training.optimizers import AdamW, OptimizerConfig
from swapnet_tpu_torch.training.state import GANTrainState

VGG_SEED = 7  # the JAX package draws its random VGG from key 7


class TextureSystem(BaseGANSystem):
    def __init__(
        self,
        texture_channels: int = 3,
        cloth_channels: int = 19,
        num_roi: int = 12,
        img_size: int = 128,
        netG: str = "swapnet",
        norm: str = "instance",
        lambda_l1: float = 10.0,
        lambda_content: float = 20.0,
        lambda_style: float = 1e-8,
        vgg_state_dict: Optional[Mapping[str, torch.Tensor]] = None,  # random if None
        discriminator: str = "basic",
        n_layers_D: int = 3,
        quantize_D: bool = False,
        init_type: str = "kaiming",
        init_gain: float = 0.02,
        dtype: torch.dtype = torch.float32,
        gan_cfg: GANLossConfig = GANLossConfig(),
        g_opt: OptimizerConfig = OptimizerConfig(lr=1e-4),
        d_opt: OptimizerConfig = OptimizerConfig(lr=4e-4, weight_decay=0.01),
        lambda_gan: float = 1.0,
        lambda_discriminator: float = 1.0,
        lambda_gp: float = 10.0,
        wgan_clamp: bool = True,
        is_train: bool = True,
        compat_image_gram: bool = True,
        compat_eps_outside: bool = False,
        dropout: float = 0.5,  # TextureModule's own default in both packages
        device: DeviceLike = None,
        # TPU-only forms of the same math, accepted and ignored (see above)
        remat_perceptual: bool = False,
        vgg_conv_impl: str = "xla",
        up0_impl: str = "auto",
        fuse_l0: bool = True,
        pool_bwd: str = "stack",
        d_conv_impl: str = "auto",
        vgg_block1_s2d: bool = True,
    ):
        if netG != "swapnet":
            raise NotImplementedError(f"netG={netG!r} is not ported yet")
        if quantize_D:
            raise NotImplementedError("quantize_D (int8 D) is not ported yet")
        super().__init__(gan_cfg, g_opt, d_opt, lambda_gan, lambda_discriminator, lambda_gp,
                         wgan_clamp)
        self.device = resolve_device(device)
        self.texture_channels, self.cloth_channels = texture_channels, cloth_channels
        self.num_roi, self.img_size, self.norm = num_roi, img_size, norm
        self.discriminator, self.n_layers_D = discriminator, n_layers_D
        self.init_type, self.init_gain, self.dtype = init_type, init_gain, dtype
        self.dropout = dropout
        self.is_train = is_train
        self.lambda_l1 = lambda_l1
        self.lambda_content = lambda_content
        self.lambda_style = lambda_style
        self.use_perceptual = is_train and (lambda_content != 0 or lambda_style != 0)
        self.vgg_state_dict = vgg_state_dict
        self.perc_cfg = PerceptualLossConfig(
            use_style=lambda_style != 0, compat_image_gram=compat_image_gram,
            compat_eps_outside=compat_eps_outside)

    def init_state(self, seed: int = 0) -> GANTrainState:
        """G, D, the frozen VGG and both optimizers on ``self.device``.
        Weights are drawn from a CPU generator seeded with ``seed`` (the VGG
        from ``VGG_SEED`` unless ``vgg_state_dict`` was given); the step
        generator lives on the device and is seeded with ``seed`` too."""
        g = torch.Generator().manual_seed(seed)
        kw = dict(init_type=self.init_type, init_gain=self.init_gain, dtype=self.dtype,
                  generator=g)
        G = TextureModule(self.texture_channels, self.cloth_channels, self.num_roi,
                          norm_type=self.norm, dropout=self.dropout, img_size=self.img_size,
                          **kw).to(self.device)
        D = d_opt = vgg = None
        if self.is_train:
            D = define_D(self.cloth_channels + self.texture_channels, self.discriminator, 64,
                         self.n_layers_D, self.norm, **kw).to(self.device)
            d_opt = AdamW(D.parameters(), self.d_opt_cfg)
        if self.use_perceptual:
            vgg = VGG16Features(self.dtype, torch.Generator().manual_seed(VGG_SEED))
            if self.vgg_state_dict is not None:
                vgg.load_state_dict(self.vgg_state_dict)
            vgg = vgg.to(self.device).requires_grad_(False).eval()
        rng = torch.Generator(device=self.device).manual_seed(seed)
        return GANTrainState(step=0, rng=rng, G=G, g_opt=AdamW(G.parameters(), self.g_opt_cfg),
                             D=D, d_opt=d_opt, vgg=vgg)

    # ---- hooks -----------------------------------------------------------

    def generator_forward(self, state: GANTrainState, batch: Batch) -> torch.Tensor:
        return state.G(batch["input_textures"], batch["rois"], batch["cloths"], state.rng)

    def d_condition(self, batch: Batch, img: torch.Tensor) -> torch.Tensor:
        return torch.cat([batch["cloths"].to(img.dtype), img], dim=1)

    def targets(self, batch: Batch) -> torch.Tensor:
        return batch["target_textures"]

    def extra_g_losses(self, state: GANTrainState, fakes: torch.Tensor,
                       batch: Batch) -> Dict[str, torch.Tensor]:
        targets = batch["target_textures"]
        out = {}
        if self.lambda_l1:
            out["loss_G_l1"] = (fakes.float() - targets.float()).abs().mean() * self.lambda_l1
        if self.use_perceptual:
            content, style = perceptual_loss(state.vgg, fakes, targets, self.perc_cfg)
            if self.lambda_content:
                out["loss_G_content"] = content * self.lambda_content
            if self.lambda_style:
                out["loss_G_style"] = style * self.lambda_style
        return out

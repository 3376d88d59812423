"""Models of the port: the U-Net generator and the PatchGAN discriminator,
3D or 2D, their blocks and the reference-named constructors.

The reference-named ``discriminator`` function lives at its reference
import path, ``transfer_em_tpu_torch.models.discriminator.discriminator``:
re-exported here, its name would shadow the submodule.
"""

from .blocks import ConvND, ConvTransposeND, DownBlock, InstanceNorm, UpBlock
from .discriminator import Discriminator, build_discriminator
from .generator import UNetGenerator, build_generator, unet_generator
from .utils import InstanceNormalization, downsample, upsample

__all__ = [
    "ConvND", "ConvTransposeND", "DownBlock", "InstanceNorm", "UpBlock",
    "Discriminator", "build_discriminator",
    "UNetGenerator", "build_generator", "unet_generator",
    "InstanceNormalization", "downsample", "upsample",
]

"""Models of the port: the 3D U-Net generator and the 3D discriminator."""

from .discriminator import Discriminator
from .generator import UNetGenerator

__all__ = ["Discriminator", "UNetGenerator"]

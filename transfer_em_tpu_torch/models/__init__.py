"""Models of the port (3D U-Net generator for this slice)."""

from .generator import UNetGenerator

__all__ = ["UNetGenerator"]

"""Tile rasterizer: projection, binning, blend (kernel K1) and the render API."""

from .api import (RasterSettings, render, render_from_camera,
                  render_model_and_stable)

__all__ = ["RasterSettings", "render", "render_from_camera",
           "render_model_and_stable"]

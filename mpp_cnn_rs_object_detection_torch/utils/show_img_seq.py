"""Image-stack sequence viewer over the raster plotter's axes.

Counterpart of ``mpp_cnn_rs_object_detection_tpu/utils/show_img_seq.py``:
a frame stack over one or more ``utils/raster_plot.py`` axes, each frame
drawn by a user callback ``display_method(index, axs, data)``, stepped by
key events (right and left, clamped at the ends; ``e`` writes the current
frame). The card's host has no GUI, so ``show_image_sequence`` opens no
window and returns None (as the JAX package's does under matplotlib's Agg
backend); ``export_frames`` renders every frame to PNG.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np

from mpp_cnn_rs_object_detection_torch.utils import raster_plot as rp


class ImageStackDisplay:
    """Frame navigator over ``axs`` (one ``Axes`` or an array of them);
    ``key(event)`` takes any object with a ``.key`` attribute."""

    def __init__(self, axs, display_method: Callable,
                 plot_data_list: List[Dict], save_path: Optional[str] = None,
                 save_prefix: str = "frame"):
        self.axs = axs
        self.data = plot_data_list
        self.n_frames = len(plot_data_list)
        self.ind = 0
        self.display_method = display_method
        self.save_path = save_path
        self.save_prefix = save_prefix
        self.update()

    def key(self, event) -> None:
        if event.key == "right":
            self.ind = min(self.ind + 1, self.n_frames - 1)
        elif event.key == "left":
            self.ind = max(self.ind - 1, 0)
        elif event.key == "e" and self.save_path is not None:
            fig = self._fig()
            fig.tight_layout()
            fig.savefig(os.path.join(self.save_path,
                                     f"{self.save_prefix}_{self.ind:03}.png"))
        self.update()

    def _fig(self) -> rp.Figure:
        return (self.axs.ravel()[0].figure
                if isinstance(self.axs, np.ndarray) else self.axs.figure)

    def update(self) -> None:
        """Clear the axes and draw the current frame."""
        for ax in (self.axs.ravel() if isinstance(self.axs, np.ndarray)
                   else [self.axs]):
            ax.clear()
        self.display_method(self.ind, self.axs, self.data)


def _subplots(n_axes: Union[int, Sequence[int]]):
    if isinstance(n_axes, int):
        return rp.subplots(1, n_axes, squeeze=n_axes == 1)
    return rp.subplots(*n_axes)


def show_image_sequence(plot_data_list: List[Dict], display_method: Callable,
                        n_axes: Union[int, Sequence[int]] = 1,
                        save_path: Optional[str] = None) -> None:
    """No window to open here: returns None; use ``export_frames``."""
    return None


def export_frames(plot_data_list: List[Dict], display_method: Callable,
                  out_dir: str, n_axes: Union[int, Sequence[int]] = 1,
                  prefix: str = "frame", dpi: int = 110) -> List[str]:
    """Render every frame to ``out_dir/{prefix}_NNN.png`` (the default
    figure size, 6.4 x 4.8 inches, at ``dpi``); returns the paths."""
    os.makedirs(out_dir, exist_ok=True)
    fig, axs = _subplots(n_axes)
    paths = []
    for i in range(len(plot_data_list)):
        for ax in (axs.ravel() if isinstance(axs, np.ndarray) else [axs]):
            ax.clear()
        display_method(i, axs, plot_data_list)
        fig.tight_layout()
        out = os.path.join(out_dir, f"{prefix}_{i:03}.png")
        fig.savefig(out, dpi=dpi)
        paths.append(out)
    return paths

"""Pixel-perfect image stacks ("light display"; counterpart of
``mpp_cnn_rs_object_detection_tpu/utils/light_display.py``, reference
``utils/display/light_display/image_stack.py`` ~232 LoC): compose image grids
with exact pixels (no matplotlib resampling), normalisation helpers, and a
tiny 3x5 bitmap font for labels."""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

# 3x5 bitmap glyphs for labels (digits + a few letters)
_FONT = {
    "0": ["111", "101", "101", "101", "111"],
    "1": ["010", "110", "010", "010", "111"],
    "2": ["111", "001", "111", "100", "111"],
    "3": ["111", "001", "111", "001", "111"],
    "4": ["101", "101", "111", "001", "001"],
    "5": ["111", "100", "111", "001", "111"],
    "6": ["111", "100", "111", "101", "111"],
    "7": ["111", "001", "010", "010", "010"],
    "8": ["111", "101", "111", "101", "111"],
    "9": ["111", "101", "111", "001", "111"],
    ".": ["000", "000", "000", "000", "010"],
    "-": ["000", "000", "111", "000", "000"],
    " ": ["000", "000", "000", "000", "000"],
    "e": ["000", "111", "101", "110", "011"],
    "a": ["000", "011", "101", "101", "011"],
    "v": ["000", "101", "101", "101", "010"],
    "l": ["100", "100", "100", "100", "110"],
    "t": ["010", "111", "010", "010", "001"],
    "n": ["000", "110", "101", "101", "101"],
    "i": ["010", "000", "010", "010", "010"],
}


def to_rgb(image: np.ndarray, normalize: bool = False,
           cmap_range: Optional[Tuple[float, float]] = None) -> np.ndarray:
    """Any (H, W[, C]) array -> float RGB in [0, 1]."""
    img = np.asarray(image, np.float32)
    if normalize or cmap_range is not None:
        lo, hi = (
            cmap_range
            if cmap_range is not None
            else (float(img.min()), float(img.max()))
        )
        img = (img - lo) / max(hi - lo, 1e-8)
    img = np.clip(img, 0, 1)
    if img.ndim == 2:
        img = np.stack([img] * 3, -1)
    return img[..., :3]


def draw_text(image: np.ndarray, text: str, origin=(1, 1),
              color=(1.0, 1.0, 1.0), scale: int = 1) -> np.ndarray:
    """Stamp a bitmap-font label onto an RGB image (in place on a copy)."""
    img = image.copy()
    y0, x0 = origin
    x = x0
    for ch in str(text).lower():
        glyph = _FONT.get(ch)
        if glyph is None:
            x += 4 * scale
            continue
        for r, row in enumerate(glyph):
            for c, bit in enumerate(row):
                if bit == "1":
                    ys = slice(y0 + r * scale, y0 + (r + 1) * scale)
                    xs = slice(x + c * scale, x + (c + 1) * scale)
                    if ys.stop <= img.shape[0] and xs.stop <= img.shape[1]:
                        img[ys, xs] = color
        x += 4 * scale
    return img


def make_image_from_bunch(images: Sequence[np.ndarray], border: int = 2,
                          border_value: float = 1.0,
                          n_cols: Optional[int] = None) -> np.ndarray:
    """Grid-stack same-sized RGB images with borders (pixel-exact)."""
    imgs = [to_rgb(i) for i in images]
    h, w = imgs[0].shape[:2]
    assert all(i.shape[:2] == (h, w) for i in imgs), "sizes must match"
    n = len(imgs)
    cols = n_cols or int(np.ceil(np.sqrt(n)))
    rows = int(np.ceil(n / cols))
    canvas = np.full(
        (rows * (h + border) + border, cols * (w + border) + border, 3),
        border_value,
        np.float32,
    )
    for i, img in enumerate(imgs):
        r, c = divmod(i, cols)
        y = border + r * (h + border)
        x = border + c * (w + border)
        canvas[y : y + h, x : x + w] = img
    return canvas


def stack_rows(rows: List[List[np.ndarray]], border: int = 2,
               labels: Optional[List[str]] = None) -> np.ndarray:
    """One grid row per list (e.g. [inputs, predictions, targets])."""
    out_rows = []
    for i, row in enumerate(rows):
        grid = make_image_from_bunch(row, border=border, n_cols=len(row))
        if labels is not None:
            grid = draw_text(grid, labels[i], origin=(border, border))
        out_rows.append(grid)
    w = max(r.shape[1] for r in out_rows)
    out_rows = [
        np.pad(r, ((0, 0), (0, w - r.shape[1]), (0, 0)), constant_values=1.0)
        for r in out_rows
    ]
    return np.concatenate(out_rows, axis=0)

"""Grid-box positions and grid views (port of xlxmert_tpu/utils/boxes.py:
`box_position`, `grid_view` and `original_view`)."""
from __future__ import annotations

import numpy as np


def box_position(grid_size: int = 8) -> np.ndarray:
    """Normalized (x0, y0, x1, y1) boxes for every cell of a grid_size x
    grid_size grid, row-major. Returns (grid_size**2, 4) float32."""
    boxes = np.zeros((grid_size ** 2, 4), dtype=np.float32)
    for i in range(grid_size):
        for j in range(grid_size):
            boxes[i * grid_size + j] = (j / grid_size, i / grid_size,
                                        (j + 1) / grid_size,
                                        (i + 1) / grid_size)
    return boxes


def grid_view(feats, grid_size: int = 8):
    """(..., G*G, D) -> (..., G, G, D) (image_generator/src/
    data_utils.py:19-46); numpy arrays and tensors alike."""
    return feats.reshape(*feats.shape[:-2], grid_size, grid_size,
                         feats.shape[-1])


def original_view(feats):
    """(..., G, G, D) -> (..., G*G, D)."""
    g = feats.shape[-2]
    return feats.reshape(*feats.shape[:-3], g * g, feats.shape[-1])

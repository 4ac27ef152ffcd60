"""Grid-box positions (port of xlxmert_tpu/utils/boxes.py::box_position)."""
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

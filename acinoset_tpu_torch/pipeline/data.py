"""Data helpers of acinoset_tpu.pipeline.data that the port needs: for
now the checkerboard's object points (the reference's
src/calib/utils.py:10-13)."""
from __future__ import annotations

from typing import Tuple

import numpy as np


def create_board_object_pts(board_shape: Tuple[int, int], square_edge_length: float) -> np.ndarray:
    """(rows * cols, 3) float32 corners of a planar board at z = 0."""
    object_pts = np.zeros((board_shape[0] * board_shape[1], 3), np.float32)
    object_pts[:, :2] = (
        np.mgrid[0 : board_shape[0], 0 : board_shape[1]].T.reshape(-1, 2) * square_edge_length
    )
    return object_pts

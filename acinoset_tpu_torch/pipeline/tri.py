"""Pairwise DLT triangulation of a run, the array core of
acinoset_tpu.pipeline.tri (no file I/O)."""
from __future__ import annotations

import numpy as np
import torch

from ..ops import camera as cam_ops


def triangulate_run(pixels, valid, k_arr, d_arr, r_arr, t_arr, device,
                    dtype=torch.float64) -> np.ndarray:
    """(N, L, 3) numpy positions for one run's numpy pixels (C, N, L, 2)
    and valid mask (C, N, L), computed on ``device``."""
    px = torch.as_tensor(np.asarray(pixels), dtype=dtype, device=device)
    ok = torch.as_tensor(np.asarray(valid), device=device)
    cams = [torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
            for a in (k_arr, d_arr, r_arr, t_arr)]
    return cam_ops.triangulate_pairwise_mean(px, ok, *cams)[0].cpu().numpy()

"""Checkerboard corner detection, the counterpart of
acinoset_tpu.calib.corners (the reference's cv2.findChessboardCorners +
cornerSubPix, src/calib/points.py:24-43).

The pixel-dense work runs on the device in float32, batched over frames
(F, H, W): grayscale, Gaussian smoothing, the saddle-point (X-corner)
response -det(Hessian), non-max suppression, the candidates' top-k, and
the gradient-orthogonality subpixel refinement. The smoothing is
explicit float32 shifted multiply-adds (no convolution library, so no
TF32 on the tensor cores), and every step is elementwise, a max, a
stable sort or a gather, so the device and the CPU give the same
candidates. Growing the (h, w) lattice out of a frame's candidates is a
small combinatorial search on the host (numpy + scipy's cKDTree), copied
from the JAX package as is.
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.device import resolve_device
from ..utils.png import read_png
from . import native

#: the JAX package's luminance weights, BGR order, applied to the RGB
#: arrays it reads (kept as is: the reference's outputs depend on them)
LUMA_WEIGHTS = (0.114, 0.587, 0.299)
#: device memory a chunk of frames may take in the dense pass, at about
#: ten float32 frame-sized intermediates a frame
CHUNK_BYTES = 4 << 30
INTERMEDIATES = 10
ENGINES = ("torch", "native")


# --------------------------------------------------------------------------
# Dense image ops (torch, batched over frames)
# --------------------------------------------------------------------------


def _gauss_kernel1d(sigma: float, radius: int, dtype):
    """The normalised taps, on the CPU: every device smooths with the
    same values."""
    x = torch.arange(-radius, radius + 1, dtype=dtype)
    k = torch.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def _sep_conv(img, k):
    """Separable 2D correlation of img (..., H, W) with the 1D taps k,
    edge-padded to the same size, as float multiply-adds in tap order."""
    pad = (k.shape[0] - 1) // 2
    out = img
    for axis in (-2, -1):
        n = out.shape[axis]
        idx = torch.arange(-pad, n + pad, device=img.device).clamp(0, n - 1)
        padded = out.index_select(out.dim() + axis, idx)
        out = padded.narrow(axis, 0, n) * k[0]
        for t in range(1, k.shape[0]):
            out += padded.narrow(axis, t, n) * k[t]
    return out


def saddle_response(gray: torch.Tensor, sigma: float = 2.0) -> torch.Tensor:
    """-det(Hessian) of the smoothed images (..., H, W), clipped at 0;
    positive at X-corners."""
    k = _gauss_kernel1d(sigma, int(3 * sigma), gray.dtype).to(gray.device)
    g = _sep_conv(gray, k)
    # central differences, wrapping at the edges as jnp.roll does
    right, left = torch.roll(g, -1, -1), torch.roll(g, 1, -1)
    down, up = torch.roll(g, -1, -2), torch.roll(g, 1, -2)
    gx = (right - left) / 2.0
    gxx = right - 2 * g + left
    gyy = down - 2 * g + up
    del right, left, down, up, g
    gxy = (torch.roll(gx, -1, -2) - torch.roll(gx, 1, -2)) / 2.0
    resp = -(gxx * gyy - gxy * gxy)
    # suppress plain edges: a saddle needs both curvatures significant
    return torch.clamp(resp, min=0.0)


def _maxpool_same(x, size):
    """Max filter over a size x size window (size odd), same extent. It
    pads with -inf where the JAX package's rolls wrap around; the two
    differ only within size // 2 of the edge, which the candidates'
    border excludes."""
    H, W = x.shape[-2:]
    pooled = F.max_pool2d(x.reshape(-1, 1, H, W), size, stride=1, padding=size // 2)
    return pooled.reshape(x.shape)


def find_corner_candidates(
    gray: torch.Tensor, max_corners: int = 256, sigma: float = 2.0, nms_size: int = 9
):
    """Return (xy (..., K, 2) pixel coordinates, scores (..., K)) of the
    NMS peaks of gray (..., H, W), sorted by descending response, the
    lower flat index first among equal scores (as jax.lax.top_k orders
    them). Fixed K = max_corners (padded with score 0)."""
    resp = saddle_response(gray, sigma)
    pooled = _maxpool_same(resp, nms_size)
    is_peak = (resp >= pooled) & (resp > 0)
    del pooled
    # exclude a small image border
    W = resp.shape[-1]
    b = 8
    border = torch.zeros_like(is_peak)
    border[..., b:-b, b:-b] = True
    score = torch.where(is_peak & border, resp, 0.0)
    flat = score.reshape(*score.shape[:-2], -1)
    vals, idx = torch.sort(flat, dim=-1, descending=True, stable=True)
    vals, idx = vals[..., :max_corners], idx[..., :max_corners]
    ys = torch.div(idx, W, rounding_mode="floor").to(gray.dtype)
    xs = (idx % W).to(gray.dtype)
    return torch.stack([xs, ys], dim=-1), vals


def _bilinear(img, xy):
    """Bilinear samples of img (F, H, W) at float points xy (F, ..., 2)
    (x, y) of the same frame: (F, ...)."""
    H, W = img.shape[-2:]
    x = torch.clamp(xy[..., 0], 0.0, W - 1.001)
    y = torch.clamp(xy[..., 1], 0.0, H - 1.001)
    x0 = torch.floor(x).to(torch.int32)
    y0 = torch.floor(y).to(torch.int32)
    fx = x - x0
    fy = y - y0
    flat = img.reshape(img.shape[0], -1)

    def at(yy, xx):
        idx = (yy.to(torch.int64) * W + xx).reshape(img.shape[0], -1)
        return torch.gather(flat, 1, idx).reshape(yy.shape)

    v00 = at(y0, x0)
    v01 = at(y0, x0 + 1)
    v10 = at(y0 + 1, x0)
    v11 = at(y0 + 1, x0 + 1)
    return (
        v00 * (1 - fx) * (1 - fy)
        + v01 * fx * (1 - fy)
        + v10 * (1 - fx) * fy
        + v11 * fx * fy
    )


def refine_subpixel(
    gray: torch.Tensor, corners: torch.Tensor, win: int = 5, iters: int = 10
) -> torch.Tensor:
    """cornerSubPix-style refinement of corner locations (F, K, 2) in the
    frames gray (F, H, W): ``iters`` fixed steps of a 2 x 2 solve a
    corner (kept where |det| <= 1e-9), with no host sync."""
    dtype = gray.dtype
    k = _gauss_kernel1d(1.5, 4, dtype).to(gray.device)
    g = _sep_conv(gray, k)
    # central differences, wrapping at the edges as jnp.roll does
    gx_img = (torch.roll(g, -1, -1) - torch.roll(g, 1, -1)) / 2.0
    gy_img = (torch.roll(g, -1, -2) - torch.roll(g, 1, -2)) / 2.0
    del g

    r = torch.arange(-win, win + 1, dtype=dtype)
    offs = torch.stack(torch.meshgrid(r, r, indexing="xy"), dim=-1).reshape(-1, 2)  # (dx, dy)
    # Gaussian window weights like cv2
    ww = torch.exp(-0.5 * torch.sum((offs / (win * 0.5)) ** 2, dim=1))
    offs, ww = offs.to(gray.device), ww.to(gray.device)

    c = corners
    for _ in range(iters):
        p = c[..., None, :] + offs  # (F, K, W2, 2)
        gx = _bilinear(gx_img, p)
        gy = _bilinear(gy_img, p)
        a = torch.sum(ww * gx * gx, dim=-1)
        b2 = torch.sum(ww * gx * gy, dim=-1)
        cc = torch.sum(ww * gy * gy, dim=-1)
        bx = torch.sum(ww * (gx * gx * p[..., 0] + gx * gy * p[..., 1]), dim=-1)
        by = torch.sum(ww * (gx * gy * p[..., 0] + gy * gy * p[..., 1]), dim=-1)
        det = a * cc - b2 * b2
        # (A + 1e-9 I) sol = (bx, by), in closed form
        a_r, c_r = a + 1e-9, cc + 1e-9
        det_r = a_r * c_r - b2 * b2
        sol = torch.stack([(c_r * bx - b2 * by) / det_r, (a_r * by - b2 * bx) / det_r], dim=-1)
        c = torch.where((torch.abs(det) > 1e-9)[..., None], sol, c)
    return c


# --------------------------------------------------------------------------
# Lattice recovery (host NumPy — tiny combinatorial problem)
# --------------------------------------------------------------------------


def _grow_grid(cands: np.ndarray, scores: np.ndarray, board_shape: Tuple[int, int]):
    """Grow an (h x w) lattice through candidate points.

    Returns (grid (h, w, 2), ok). Greedy BFS from multiple seeds (in
    descending response order): estimate two roughly-orthogonal short
    lattice vectors among a seed's neighbors, then extrapolate
    cell-by-cell (p[i+1] ~ 2p[i] - p[i-1]) snapping to the nearest
    candidate. The first seed whose lattice reaches the full board wins.
    """
    want_h, want_w = board_shape
    n_need = want_h * want_w
    keep = scores > 0
    pts = cands[keep]
    pts_scores = scores[keep]
    if len(pts) < n_need:
        return None, False

    from scipy.spatial import cKDTree

    tree = cKDTree(pts)
    order = np.argsort(-pts_scores)
    for seed in order[: min(len(order), 40)]:
        out = _grow_from_seed(pts, pts_scores, tree, int(seed), want_h, want_w, n_need)
        if out is not None:
            return out, True
    return None, False


def _grow_from_seed(pts, pts_scores, tree, seed, want_h, want_w, n_need):
    d, nn = tree.query(pts[seed], k=min(9, len(pts)))
    neigh = pts[nn[1:]] - pts[seed]
    lens = np.linalg.norm(neigh, axis=1)
    v1 = neigh[np.argmin(lens)]
    cosang = np.abs(neigh @ v1) / (lens * np.linalg.norm(v1) + 1e-9)
    cand2 = np.where((cosang < 0.5) & (lens < 2.0 * np.linalg.norm(v1)))[0]
    if len(cand2) == 0:
        return None
    v2 = neigh[cand2[np.argmin(lens[cand2])]]

    placed = {(0, 0): seed}
    pos = {(0, 0): pts[seed]}
    frontier = [(0, 0)]
    used = {seed}
    max_cells = 4 * n_need

    def predict(cell):
        i, j = cell
        ests = []
        for di, dj in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            a, b = (i - di, j - dj), (i - 2 * di, j - 2 * dj)
            if a in pos and b in pos:
                ests.append(2 * pos[a] - pos[b])
        for di, dj in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            a = (i - di, j - dj)
            if a in pos and not ests:
                base = v1 * di + v2 * dj
                ests.append(pos[a] + base)
        if not ests:
            return None
        return np.mean(ests, axis=0)

    while frontier and len(placed) < max_cells:
        cell = frontier.pop(0)
        i, j = cell
        for di, dj in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            nxt = (i + di, j + dj)
            if nxt in pos:
                continue
            est = predict(nxt)
            if est is None:
                continue
            dist, k = tree.query(est)
            # local spacing estimate
            spacing = np.linalg.norm(v1) if di else np.linalg.norm(v2)
            near = pos.get(cell)
            if near is not None:
                spacing = max(np.linalg.norm(est - near) * 0.999, 1e-3)
            if dist < 0.35 * spacing and k not in used:
                pos[nxt] = pts[k]
                placed[nxt] = k
                used.add(k)
                frontier.append(nxt)

    if len(placed) < n_need:
        return None

    # among all fully-populated (h, w)/(w, h) sub-windows, keep the one
    # with the smoothest lattice (smallest max second difference) —
    # rejects windows that wandered onto off-board candidates
    cells = np.array(list(pos.keys()))
    imin, jmin = cells.min(axis=0)
    imax, jmax = cells.max(axis=0)
    candidates = []
    for (hh, ww) in ((want_h, want_w), (want_w, want_h)):
        for i0 in range(imin, imax - hh + 2):
            for j0 in range(jmin, jmax - ww + 2):
                window = [(i0 + a, j0 + b) for a in range(hh) for b in range(ww)]
                if all(c in pos for c in window):
                    grid = np.array([pos[c] for c in window]).reshape(hh, ww, 2)
                    resp = float(sum(pts_scores[placed[c]] for c in window))
                    if (hh, ww) != (want_h, want_w):
                        grid = grid.transpose(1, 0, 2)
                    candidates.append((_lattice_roughness(grid), -resp, len(candidates), grid))
    if not candidates:
        return None
    # true inner corners carry the strongest saddle response: among
    # windows that are comparably smooth (shift-ambiguous lattices
    # extending past the board edge), take the highest total response
    best_rough = min(c[0] for c in candidates)
    pool = [c for c in candidates if c[0] <= max(1.5 * best_rough, best_rough + 1.0)]
    pool.sort(key=lambda c: c[1])
    return _repair_lattice_outliers(pool[0][3])


def _lattice_roughness(grid: np.ndarray) -> float:
    """Max second-difference magnitude across both lattice axes."""
    d2i = grid[2:] - 2 * grid[1:-1] + grid[:-2]
    d2j = grid[:, 2:] - 2 * grid[:, 1:-1] + grid[:, :-2]
    return max(np.abs(d2i).max(initial=0.0), np.abs(d2j).max(initial=0.0))


def _repair_lattice_outliers(grid: np.ndarray, spike_factor: float = 4.0) -> np.ndarray:
    """Replace cells that spike the lattice Laplacian with smooth
    extrapolations from their neighbors (subpixel refinement then pulls
    them onto the true corner)."""
    h, w, _ = grid.shape
    lap = np.zeros((h, w))
    d2i = grid[2:] - 2 * grid[1:-1] + grid[:-2]
    d2j = grid[:, 2:] - 2 * grid[:, 1:-1] + grid[:, :-2]
    lap[1:-1] += np.linalg.norm(d2i, axis=-1)
    lap[:, 1:-1] += np.linalg.norm(d2j, axis=-1)
    med = np.median(lap[lap > 0]) if (lap > 0).any() else 0.0
    bad = lap > spike_factor * max(med, 0.5)
    if not bad.any():
        return grid
    out = grid.copy()
    for i, j in zip(*np.where(bad)):
        ests = []
        if 1 <= i <= h - 2 and not bad[i - 1, j] and not bad[i + 1, j]:
            ests.append(0.5 * (grid[i - 1, j] + grid[i + 1, j]))
        if 1 <= j <= w - 2 and not bad[i, j - 1] and not bad[i, j + 1]:
            ests.append(0.5 * (grid[i, j - 1] + grid[i, j + 1]))
        if i >= 2 and not bad[i - 1, j] and not bad[i - 2, j]:
            ests.append(2 * grid[i - 1, j] - grid[i - 2, j])
        if i <= h - 3 and not bad[i + 1, j] and not bad[i + 2, j]:
            ests.append(2 * grid[i + 1, j] - grid[i + 2, j])
        if j >= 2 and not bad[i, j - 1] and not bad[i, j - 2]:
            ests.append(2 * grid[i, j - 1] - grid[i, j - 2])
        if j <= w - 3 and not bad[i, j + 1] and not bad[i, j + 2]:
            ests.append(2 * grid[i, j + 1] - grid[i, j + 2])
        if ests:
            out[i, j] = np.mean(ests, axis=0)
    return out


def _canonicalize(grid: np.ndarray) -> np.ndarray:
    """Deterministic corner ordering: first corner is the lattice corner
    closest to the image origin; rows advance along the board's first
    axis. Resolves the detector's 4-fold orientation ambiguity."""
    h, w, _ = grid.shape
    corners4 = [grid[0, 0], grid[0, -1], grid[-1, 0], grid[-1, -1]]
    which = int(np.argmin([np.hypot(*c) for c in corners4]))
    if which == 1:
        grid = grid[:, ::-1]
    elif which == 2:
        grid = grid[::-1, :]
    elif which == 3:
        grid = grid[::-1, ::-1]
    return np.ascontiguousarray(grid)


# --------------------------------------------------------------------------
# Frames -> corners
# --------------------------------------------------------------------------


def _gray(images: Sequence[np.ndarray], device) -> torch.Tensor:
    """(F, H, W) float32 frames on ``device`` from same-size images
    (H, W) or RGB (H, W, 3), as the JAX package makes them on the host:
    the BGR weights applied to the RGB channels and a rescale by 1/255
    where the frame's maximum exceeds 2, both in float64."""
    x = torch.from_numpy(np.stack([np.asarray(im) for im in images])).to(device)
    x = x.to(torch.float64)
    if x.dim() == 4:
        if x.shape[-1] != 3:
            raise ValueError(f"expected grey or 3-channel frames, got {x.shape[-1]} channels")
        w0, w1, w2 = LUMA_WEIGHTS
        x = x[..., 0] * w0 + x[..., 1] * w1 + x[..., 2] * w2
    peak = x.amax(dim=(-2, -1), keepdim=True)
    return torch.where(peak > 2, x / 255.0, x).to(torch.float32)


def find_corners_batch(
    images: Sequence[np.ndarray],
    board_shape: Tuple[int, int],
    sigma: float = 2.0,
    max_candidates: int = 256,
    device=None,
):
    """Detect an (h, w) checkerboard in each of a list of same-size
    images. The dense pass runs on ``device`` (``cuda`` unless given) in
    chunks of frames that fit CHUNK_BYTES; each frame's lattice is grown
    on the host, then the chunk's found frames are refined in one
    batched call. Returns (grids (F, h, w, 2) float64 with NaN where not
    found, found (F,) bool), as calib.native.find_corners_batch does."""
    device = resolve_device(device)
    n = len(images)
    grids = np.full((n, board_shape[0], board_shape[1], 2), np.nan)
    found = np.zeros(n, bool)
    if n == 0:
        return grids, found
    H, W = np.shape(images[0])[:2]
    step = max(1, CHUNK_BYTES // (INTERMEDIATES * 4 * H * W))
    for s in range(0, n, step):
        gray = _gray(images[s:s + step], device)
        cand, scores = find_corner_candidates(gray, max_corners=max_candidates, sigma=sigma)
        cand, scores = cand.cpu().numpy(), scores.cpu().numpy()
        lattices = [_grow_grid(c, sc, board_shape) for c, sc in zip(cand, scores)]
        hit = [i for i, (_, ok) in enumerate(lattices) if ok]
        if not hit:
            continue
        start = np.stack([lattices[i][0].reshape(-1, 2) for i in hit]).astype(np.float32)
        refined = refine_subpixel(gray[hit], torch.as_tensor(start, device=device))
        refined = refined.cpu().numpy().astype(np.float64)
        for j, i in enumerate(hit):
            grids[s + i] = _canonicalize(refined[j].reshape(lattices[i][0].shape))
            found[s + i] = True
    return grids, found


def find_corners(
    image: np.ndarray,
    board_shape: Tuple[int, int],
    sigma: float = 2.0,
    max_candidates: int = 256,
    device=None,
) -> Tuple[Optional[np.ndarray], bool]:
    """Detect an (h, w) checkerboard in one image (H, W[, 3]) uint8 or
    float; twin of src/calib/points.py:24-41. Returns (corners
    (board_shape[0], board_shape[1], 2) float64, found)."""
    grids, found = find_corners_batch([image], board_shape, sigma, max_candidates, device)
    return (grids[0], True) if found[0] else (None, False)


def find_corners_images(
    image_paths: List[str],
    board_shape: Tuple[int, int],
    verbose: bool = True,
    engine: str = "torch",
    device=None,
):
    """Batch detection over PNG files (twin of src/calib/points.py:44-69).

    engine: 'torch' (the device detector, the JAX package's 'jax') or
    'native' (the multithreaded C++ engine, native/corners.cpp through
    calib.native, on the host). The JAX package's 'auto', which picks
    whichever engine is built, is refused: name the engine. Returns
    (points (F, h, w, 2), found_fnames, (width, height))."""
    if engine not in ENGINES:
        raise ValueError(f"engine={engine!r}: choose one of {ENGINES}; the port does not pick "
                         f"an engine by what is built")
    for p in image_paths:
        if p.lower().endswith((".jpg", ".jpeg")):
            raise ValueError(f"{p}: JPEG frames cannot be read: the port decodes PNG only "
                             f"(no JPEG decoder without imageio or PIL)")
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:  # zlib frees the GIL
        imgs = list(pool.map(read_png, image_paths))
    shape = imgs[0].shape[:2] if imgs else (0, 0)
    for p, im in zip(image_paths, imgs):
        if im.shape[:2] != shape:
            raise ValueError(f"Inconsistent image resolutions: {p} is {im.shape[:2]}, not {shape}")

    if engine == "native":
        grids, found = native.find_corners_batch(imgs, board_shape)
    else:
        grids, found = find_corners_batch(imgs, board_shape, device=device)
    pts, names = [], []
    for p, g, ok in zip(image_paths, grids, found):
        if ok:
            pts.append(g)
            names.append(os.path.basename(p))
            if verbose:
                print(f"Found corners in {p}")
        elif verbose:
            print(f"No checkerboard in {p}")
    return np.array(pts), names, (shape[1], shape[0])

"""Synthetic multi-camera cheetah runs (tests and chip_smoke.py), the
counterpart of acinoset_tpu.utils.synthetic: same cameras, trajectory
and numpy RNG call order, with the port's FK and projection evaluated
on the CPU in float64, so the data equal the JAX package's."""
import numpy as np
import torch

from ..models import cheetah
from ..ops import camera as cam_ops


def ring_cameras(n_cams=6, radius=12.0, height=1.2, fx=700.0, res=(2704, 1520)):
    """Cameras on an arc looking at the origin region."""
    K = np.array([[fx, 0, res[0] / 2], [0, fx, res[1] / 2], [0, 0, 1.0]])
    D = np.array([0.04, 0.005, -0.006, 0.001])
    k_arr, d_arr, r_arr, t_arr = [], [], [], []
    for a in np.linspace(-0.9, 0.9, n_cams):
        cam_pos = np.array([radius * np.sin(a), -radius * np.cos(a), height])
        z = -cam_pos / np.linalg.norm(cam_pos)  # look-at: z axis towards origin
        x = np.cross(np.array([0.0, 0.0, 1.0]), z)
        x /= np.linalg.norm(x)
        y = np.cross(z, x)
        R = np.stack([x, y, z])  # world->cam
        k_arr.append(K)
        d_arr.append(D)
        r_arr.append(R)
        t_arr.append((-R @ cam_pos).reshape(3, 1))
    return (np.stack(k_arr), np.stack(d_arr), np.stack(r_arr), np.stack(t_arr), res)


def cheetah_gallop(N=60, fps=90.0, speed=None):
    """Smooth synthetic 25-state trajectory within joint limits; the
    default speed keeps the run on the same ~9 m track at any N."""
    if speed is None:
        speed = min(8.0, 9.0 / (N / fps))
    t = np.arange(N) / fps
    pp = cheetah.get_pose_params()
    X = np.zeros((N, cheetah.N_ACTIVE))
    X[:, pp["x_0"]] = -2.0 + speed * t
    X[:, pp["y_0"]] = 0.3 * np.sin(2 * np.pi * 1.0 * t)
    X[:, pp["z_0"]] = 0.6 + 0.08 * np.sin(2 * np.pi * 3.0 * t)
    X[:, pp["psi_0"]] = 0.05 * np.sin(2 * np.pi * 0.8 * t)
    stride = 2 * np.pi * 3.0 * t  # ~3 Hz stride
    X[:, pp["theta_2"]] = 0.25 * np.sin(stride)
    X[:, pp["theta_3"]] = 0.25 * np.sin(stride + 0.7)
    X[:, pp["theta_4"]] = 0.5 * np.sin(stride + 1.2)
    X[:, pp["theta_5"]] = 0.5 * np.sin(stride + 1.5)
    X[:, pp["theta_6"]] = 0.8 * np.sin(stride)
    X[:, pp["theta_7"]] = -np.pi / 2 + 0.7 * np.sin(stride + 0.4)
    X[:, pp["theta_8"]] = 0.8 * np.sin(stride + np.pi)
    X[:, pp["theta_9"]] = -np.pi / 2 + 0.7 * np.sin(stride + np.pi + 0.4)
    X[:, pp["theta_10"]] = 0.8 * np.sin(stride + 2.0)
    X[:, pp["theta_11"]] = np.pi / 2 + 0.7 * np.sin(stride + 2.4)
    X[:, pp["theta_12"]] = 0.8 * np.sin(stride + 2.0 + np.pi)
    X[:, pp["theta_13"]] = np.pi / 2 + 0.7 * np.sin(stride + 2.4 + np.pi)
    X[:, pp["theta_0"]] = 0.1 * np.sin(stride + 0.3)
    X[:, pp["theta_1"]] = 0.1 * np.sin(stride + 0.9)
    return X


def render_measurements(X25, cams, noise_px=1.0, outlier_frac=0.02, bad_lik_frac=0.05, seed=0):
    """Project ground-truth poses into all cameras, with noise, outliers
    and low-likelihood detections. Returns numpy (pixels (C, N, L, 2),
    likelihood (C, N, L), pts3d (N, L, 3))."""
    rng = np.random.default_rng(seed)
    k_arr, d_arr, r_arr, t_arr, res = cams
    N = X25.shape[0]
    C = len(k_arr)
    L = cheetah.N_MARKERS
    pts = cheetah.fk25(torch.as_tensor(X25, dtype=torch.float64))  # (N, L, 3)
    pixels = np.zeros((C, N, L, 2))
    for c in range(C):
        pixels[c] = cam_ops.project_points_fisheye(
            pts, k_arr[c], d_arr[c], r_arr[c], t_arr[c]
        ).numpy()
    pts3d = pts.numpy()
    pixels += rng.normal(scale=noise_px, size=pixels.shape)
    likelihood = np.full((C, N, L), 0.99)
    n_out = int(outlier_frac * C * N * L)
    if n_out:
        ci = rng.integers(0, C, n_out)
        ni = rng.integers(0, N, n_out)
        li = rng.integers(0, L, n_out)
        pixels[ci, ni, li] += rng.normal(scale=80.0, size=(n_out, 2))
    n_bad = int(bad_lik_frac * C * N * L)
    if n_bad:
        ci = rng.integers(0, C, n_bad)
        ni = rng.integers(0, N, n_bad)
        li = rng.integers(0, L, n_bad)
        likelihood[ci, ni, li] = 0.1
        pixels[ci, ni, li] += rng.normal(scale=300.0, size=(n_bad, 2))
    return pixels, likelihood, pts3d

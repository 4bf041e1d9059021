"""Entry points for a quick check of the port, the twins of the JAX
package's ``__graft_entry__.py``: one flagship solve on the card
(``entry``) and a dry run of the sharded solve over CPU shards
(``dryrun_multichip``).

    python -c "from acinoset_tpu_torch import entry; entry.dryrun_multichip(8)"
"""
from __future__ import annotations

import numpy as np
import torch

from .models import cheetah
from .parallel import mesh as mesh_lib
from .pipeline.ekf import make_h_fn, make_hj_parts_fn
from .pipeline.fte import default_config
from .solvers.trajopt import fte_solve
from .utils.device import resolve_device


def tiny_problem(dtype=torch.float32, n_cams=2, n_frames=16, device=None):
    """A small synthetic FTE problem: (cfg, h_fn, hj_parts_fn, X0 (N, P),
    meas (N, C, L, 2), w (N, C, L)) on ``device`` (CUDA unless given),
    the JAX package's ``_tiny_problem``: a ring of cameras 12 m out, a
    straight-line initial trajectory, pixels scattered about the image
    centre, 2 GN iterations."""
    device = resolve_device(device)
    fx, res = 700.0, (2704, 1520)
    K = np.array([[fx, 0, res[0] / 2], [0, fx, res[1] / 2], [0, 0, 1.0]])
    D = np.array([0.04, 0.005, -0.006, 0.001])
    k_arr, d_arr, r_arr, t_arr = [], [], [], []
    for i in range(n_cams):
        a = -0.5 + i * (1.0 / max(n_cams - 1, 1))
        cam_pos = np.array([12.0 * np.sin(a), -12.0 * np.cos(a), 1.2])
        z = -cam_pos / np.linalg.norm(cam_pos)
        x = np.cross([0.0, 0.0, 1.0], z)
        x = x / np.linalg.norm(x)
        y = np.cross(z, x)
        R = np.stack([x, y, z])
        k_arr.append(K)
        d_arr.append(D)
        r_arr.append(R)
        t_arr.append((-R @ cam_pos).reshape(3, 1))
    rig = tuple(np.stack(a) for a in (k_arr, d_arr, r_arr, t_arr))

    N, P, L = n_frames, cheetah.N_ACTIVE, cheetah.N_MARKERS
    cfg = default_config(fps=90.0, num_iters=2)
    h_fn = make_h_fn(*rig, dtype, device)
    hj_parts = make_hj_parts_fn(*rig, dtype, device)
    rng = np.random.default_rng(0)
    X0 = np.zeros((N, P))
    X0[:, 0] = np.linspace(-1, 1, N)
    X0[:, 2] = 0.6
    meas = np.asarray(res).reshape(1, 1, 1, 2) / 2 + rng.normal(scale=40.0, size=(N, n_cams, L, 2))
    w = np.full((N, n_cams, L), 1.0 / 5.0)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    return cfg, h_fn, hj_parts, t(X0), t(meas), t(w)


def entry(device=None):
    """(fn, example_args): one FTE Gauss-Newton solve (2 iterations) of
    the flagship cheetah model on the card (unless ``device`` says
    otherwise), the core compute step. ``fn(X0, meas, w) -> (X (N, P),
    cost)``."""
    device = resolve_device(device)
    cfg, _h_fn, hj_parts, X0, meas, w = tiny_problem(torch.float32, device=device)

    def fn(X0, meas, w):
        X, info = fte_solve(hj_parts, X0[None], meas[None], w[None], cfg, device=device)
        return X[0], info["cost"][0]

    return fn, (X0, meas, w)


def dryrun_multichip(n_devices: int) -> None:
    """The batched FTE solve over a mesh of ``n_devices`` CPU shards
    (trajectories over 'data' x cameras over 'model', ``make_mesh``'s
    layout), one step on tiny shapes, in float32: the twin of the JAX
    package's dry run on virtual CPU devices. Prints one OK line."""
    cpu = torch.device("cpu")
    mesh = mesh_lib.make_mesh(n_devices, devices=[cpu] * n_devices)
    # the flagship camera count, or a multiple the model axis divides
    model = mesh.shape.get("model", 1)
    n_cams = 6 if 6 % model == 0 else 6 * model
    cfg, h_fn, hj_parts, X0, meas, w = tiny_problem(torch.float32, n_cams=n_cams, device=cpu)

    B = 2 * mesh.shape["data"]
    batch = mesh_lib.shard_batch(mesh, *(torch.stack([a] * B) for a in (X0, meas, w)))
    solver = mesh_lib.sharded_fte_solver(mesh, h_fn, cfg, hj_parts_fn=hj_parts)
    X = solver(batch)
    assert X.shape == (B,) + X0.shape
    print(f"dryrun_multichip OK: mesh={mesh.shape} batch={B} X={tuple(X.shape)} "
          f"finite={bool(torch.isfinite(X).all())}", flush=True)

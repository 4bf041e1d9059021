"""The 20-marker cheetah kinematic model: static tables plus FK and its
analytic Jacobian on torch tensors, the counterpart of
acinoset_tpu.models.cheetah (the reference's SymPy model,
src/all_optimizations.py:66-190).

Pose layout: x45 = [x, y, z, phi_0..13, theta_0..13, psi_0..13]; only
25 entries are active (nonzero process variance). ``fk``, ``fk25`` and
``fk25_and_jac`` broadcast over leading batch dimensions, where the JAX
package vmaps.
"""
from __future__ import annotations

import functools
from collections import OrderedDict

import numpy as np
import torch

from ..ops.rotations import mm3, mvT3, rot_x, rot_y, rot_z

N_JOINTS = 14
N_POSE = 3 + 3 * N_JOINTS  # 45

#: joint name -> (parent joint index, has_phi, has_theta, has_psi)
JOINTS = OrderedDict(
    [
        ("head", (-1, True, True, True)),
        ("neck", (0, True, True, True)),
        ("front_torso", (1, False, True, False)),
        ("back_torso", (2, True, True, True)),
        ("tail_base", (3, False, True, True)),
        ("tail_mid", (4, False, True, True)),
        ("l_shoulder", (2, False, True, False)),
        ("l_front_knee", (6, False, True, False)),
        ("r_shoulder", (2, False, True, False)),
        ("r_front_knee", (8, False, True, False)),
        ("l_hip", (3, False, True, False)),
        ("l_back_knee", (10, False, True, False)),
        ("r_hip", (3, False, True, False)),
        ("r_back_knee", (12, False, True, False)),
    ]
)

#: marker name -> (base marker index or -1 for the head root, frame joint
#: index, offset xyz in that joint's frame), in the reference's order
MARKER_SPECS = [
    ("l_eye", -1, 0, (0.0, 0.03, 0.0)),
    ("r_eye", -1, 0, (0.0, -0.03, 0.0)),
    ("nose", -1, 0, (0.055, 0.0, -0.055)),
    ("neck_base", -1, 1, (-0.28, 0.0, 0.0)),
    ("spine", 3, 2, (-0.37, 0.0, 0.0)),
    ("tail_base", 4, 3, (-0.37, 0.0, 0.0)),
    ("tail1", 5, 4, (-0.28, 0.0, 0.0)),
    ("tail2", 6, 5, (-0.36, 0.0, 0.0)),
    ("l_shoulder", 3, 2, (-0.04, 0.08, -0.10)),
    ("l_front_knee", 8, 6, (0.0, 0.0, -0.24)),
    ("l_front_ankle", 9, 7, (0.0, 0.0, -0.28)),
    ("r_shoulder", 3, 2, (-0.04, -0.08, -0.10)),
    ("r_front_knee", 11, 8, (0.0, 0.0, -0.24)),
    ("r_front_ankle", 12, 9, (0.0, 0.0, -0.28)),
    ("l_hip", 5, 3, (0.12, 0.08, -0.06)),
    ("l_back_knee", 14, 10, (0.0, 0.0, -0.32)),
    ("l_back_ankle", 15, 11, (0.0, 0.0, -0.25)),
    ("r_hip", 5, 3, (0.12, -0.08, -0.06)),
    ("r_back_knee", 17, 12, (0.0, 0.0, -0.32)),
    ("r_back_ankle", 18, 13, (0.0, 0.0, -0.25)),
]

MARKERS = [m[0] for m in MARKER_SPECS]
N_MARKERS = len(MARKERS)  # 20

#: per-45-slot model std-dev (src/all_optimizations.py:245-252); zero
#: marks an unused DoF. Q (variance) = these values squared.
Q_STD = np.array(
    [4, 7, 5]
    + [13, 32, 0, 10, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0]
    + [9, 18, 43, 53, 90, 118, 247, 186, 194, 164, 295, 243, 334, 149]
    + [26, 12, 0, 34, 43, 51, 0, 0, 0, 0, 0, 0, 0, 0],
    dtype=np.float64,
)
Q_VAR = Q_STD**2

ACTIVE_IDX = np.where(Q_STD != 0)[0]  # 25 active slots in the 45 layout
N_ACTIVE = len(ACTIVE_IDX)  # 25

#: FTE weights: measurement std (px) and redescending knots
MEAS_STD_PX = 5.0
REDESC_A, REDESC_B, REDESC_C = 3.0, 10.0, 20.0

#: EKF process-noise base std-devs per active parameter, in dense-25
#: order (the reference's qb_list, src/all_optimizations.py:734-746)
EKF_QB = np.array(
    [
        5.0, 5.0, 5.0,
        10.0, 10.0, 10.0,
        5.0, 25.0, 5.0,
        50.0,
        5.0, 50.0, 25.0,
        100.0, 30.0,
        140.0, 40.0,
        350.0, 200.0,
        350.0, 200.0,
        450.0, 400.0,
        450.0, 400.0,
    ]
)


def get_markers():
    """The 20 marker names in FK order."""
    return list(MARKERS)


def get_pose_params():
    """Ordered name -> dense-25 index of the active pose parameters."""
    names = [
        "x_0", "y_0", "z_0",
        "phi_0", "theta_0", "psi_0",
        "phi_1", "theta_1", "psi_1",
        "theta_2",
        "phi_3", "theta_3", "psi_3",
        "theta_4", "psi_4",
        "theta_5", "psi_5",
        "theta_6", "theta_7",
        "theta_8", "theta_9",
        "theta_10", "theta_11",
        "theta_12", "theta_13",
    ]
    return OrderedDict((n, i) for i, n in enumerate(names))


def _active_order_45() -> np.ndarray:
    """45-layout indices of the 25 params, in get_pose_params() order."""
    out = []
    for name in get_pose_params():
        if name in ("x_0", "y_0", "z_0"):
            out.append({"x_0": 0, "y_0": 1, "z_0": 2}[name])
        else:
            kind, j = name.split("_")
            base = {"phi": 3, "theta": 3 + N_JOINTS, "psi": 3 + 2 * N_JOINTS}[kind]
            out.append(base + int(j))
    return np.array(out)


ACTIVE_IDX_ORDERED = _active_order_45()  # dense-25 order -> 45 slots

#: dense-25 pose-param order -> the reference fte.pickle column order
FTE_SAVE_ORDER = np.argsort(ACTIVE_IDX_ORDERED)

#: gather index building x45 from [x25 | 0]: slot i reads x25[_EXPAND_SRC[i]],
#: or the appended zero (index 25) for an unused DoF
_EXPAND_SRC = np.full(N_POSE, N_ACTIVE)
_EXPAND_SRC[ACTIVE_IDX_ORDERED] = np.arange(N_ACTIVE)
#: marker offsets (L, 3) in their frame joints, MARKER_SPECS' order
_MARKER_OFFSETS = np.array([spec[3] for spec in MARKER_SPECS])


def to_fte_order(x25):
    """Dense-25 (pose-param order) -> reference fte.pickle column order."""
    return x25[..., torch.as_tensor(FTE_SAVE_ORDER, device=x25.device)]


def from_fte_order(x25_fte):
    """Reference fte.pickle column order -> dense-25 pose-param order."""
    inv = np.argsort(FTE_SAVE_ORDER)
    return x25_fte[..., torch.as_tensor(inv, device=x25_fte.device)]


def expand_pose(x25):
    """Dense active pose (..., 25) -> full 45 layout (unused slots zero).
    A gather, so it also runs under torch.func transforms."""
    padded = torch.cat([x25, torch.zeros_like(x25[..., :1])], dim=-1)
    return padded[..., _device_table("expand_src", torch.int64, x25.device)]


def compress_pose(x45):
    """Full 45 pose (..., 45) -> dense active (..., 25)."""
    return x45[..., torch.as_tensor(ACTIVE_IDX_ORDERED, device=x45.device)]


def _local_rotation(has_phi, has_theta, has_psi, phi, theta, psi):
    R = None  # compose only the axes present
    if has_theta:
        R = rot_y(theta)
    if has_phi:
        R = rot_x(phi) if R is None else mm3(rot_x(phi), R)
    if has_psi:
        R = rot_z(psi) if R is None else mm3(rot_z(psi), R)
    if R is None:
        return torch.eye(3, dtype=phi.dtype, device=phi.device).expand(phi.shape + (3, 3))
    return R


def _angles(x45):
    return (
        x45[..., 3 : 3 + N_JOINTS],
        x45[..., 3 + N_JOINTS : 3 + 2 * N_JOINTS],
        x45[..., 3 + 2 * N_JOINTS :],
    )


def fk(x45):
    """Forward kinematics: 45-pose (..., 45) -> marker positions (..., 20, 3)."""
    root = x45[..., :3]
    phi, theta, psi = _angles(x45)
    R = []  # inertial->joint DCMs
    for j, (parent, has_phi, has_theta, has_psi) in enumerate(JOINTS.values()):
        Rl = _local_rotation(has_phi, has_theta, has_psi, phi[..., j], theta[..., j], psi[..., j])
        R.append(Rl if parent < 0 else mm3(Rl, R[parent]))
    positions = []
    offsets = _device_table("offsets", x45.dtype, x45.device)
    for m, (_name, base_idx, frame_j, _offset) in enumerate(MARKER_SPECS):
        base = root if base_idx < 0 else positions[base_idx]
        positions.append(base + mvT3(R[frame_j], offsets[m]))
    return torch.stack(positions, dim=-2)


def fk25(x25):
    """FK from the dense 25-parameter pose (EKF/FTE state)."""
    return fk(expand_pose(x25))


def _jac_static_tables():
    """Static masks for the analytic FK Jacobian: (angle_specs, seg_mask
    (L, L), anc_mask (L, A), col_idx (A,)), as in the JAX package."""
    angle_specs, col_idx = [], []
    for name, col in get_pose_params().items():
        if name in ("x_0", "y_0", "z_0"):
            continue
        kind, j = name.split("_")
        angle_specs.append((kind, int(j)))
        col_idx.append(col)
    parents = [spec[0] for spec in JOINTS.values()]

    def joint_chain(j):
        out = []
        while j >= 0:
            out.append(j)
            j = parents[j]
        return out

    L = N_MARKERS
    seg_mask = np.zeros((L, L))
    for m in range(L):
        s = m
        while s >= 0:
            seg_mask[m, s] = 1.0
            s = MARKER_SPECS[s][1]
    A = len(angle_specs)
    anc_mask = np.zeros((L, A))
    for s in range(L):
        anc = set(joint_chain(MARKER_SPECS[s][2]))
        for a, (_kind, j) in enumerate(angle_specs):
            if j in anc:
                anc_mask[s, a] = 1.0
    return angle_specs, seg_mask, anc_mask, np.array(col_idx)


_JAC_ANGLES, _JAC_SEG_MASK, _JAC_ANC_MASK, _JAC_COLS = _jac_static_tables()
# J assembles as concat([I3 (root x/y/z), Jang]): valid only while the
# root translations are pose params 0-2 and the angle columns the rest
if list(_JAC_COLS) != list(range(3, N_ACTIVE)):
    raise AssertionError(_JAC_COLS)
#: combined (L, L, A) mask: marker m sums segment s under angle a
_JAC_MSA = np.einsum("ms,sa->msa", _JAC_SEG_MASK, _JAC_ANC_MASK)


@functools.lru_cache(maxsize=None)
def _device_table(name, dtype, device):
    """One of the model's constant tables as a tensor on ``device``, made
    once per (table, dtype, device): a copy from the host synchronises
    the stream, and FK runs in every frame of the EKF's loop. Read only."""
    table = {"expand_src": _EXPAND_SRC, "offsets": _MARKER_OFFSETS, "msa": _JAC_MSA}[name]
    return torch.as_tensor(table, dtype=dtype, device=device)


def fk25_and_jac(x25):
    """FK positions (..., 20, 3) and the analytic Jacobian (..., 20, 3, 25)
    in one pass: each Euler angle at joint a rotates everything below it
    about a fixed world axis omega, so d(R_f^T off)/d alpha is a cross
    product of omega with the segment vectors below the joint."""
    dtype, device = x25.dtype, x25.device
    x45 = expand_pose(x25)
    phi, theta, psi = _angles(x45)
    eye3 = torch.eye(3, dtype=dtype, device=device)
    R, Rpar = [], []
    for j, (parent, has_phi, has_theta, has_psi) in enumerate(JOINTS.values()):
        Rl = _local_rotation(has_phi, has_theta, has_psi, phi[..., j], theta[..., j], psi[..., j])
        Rp = eye3.expand(Rl.shape) if parent < 0 else R[parent]
        Rpar.append(Rp)
        R.append(Rl if parent < 0 else mm3(Rl, Rp))

    positions, segs = [], []
    root = x45[..., :3]
    offsets = _device_table("offsets", dtype, device)
    for m, (_name, base_idx, frame_j, _offset) in enumerate(MARKER_SPECS):
        v = mvT3(R[frame_j], offsets[m])
        segs.append(v)
        base = root if base_idx < 0 else positions[base_idx]
        positions.append(base + v)
    pts = torch.stack(positions, dim=-2)  # (..., L, 3)
    V = torch.stack(segs, dim=-2)  # (..., L, 3)

    omegas = []  # world rotation axis per active angle (R^T e_k = row k of R)
    for kind, j in _JAC_ANGLES:
        if kind == "theta":
            omegas.append(Rpar[j][..., 1, :])
        elif kind == "psi":
            omegas.append(R[j][..., 2, :])
        else:  # phi: Rpar^T (Ry(theta)^T x_hat)
            c, s = torch.cos(theta[..., j]), torch.sin(theta[..., j])
            omegas.append(c[..., None] * Rpar[j][..., 0, :] - s[..., None] * Rpar[j][..., 2, :])
    W = torch.stack(omegas, dim=-2)  # (..., A, 3)

    msa = _device_table("msa", dtype, device)
    T = torch.einsum("msa,...sx->...max", msa, V)  # (..., L, A, 3)
    Wb = W[..., None, :, :]  # broadcast over markers
    # frame rotations: dR/dtheta = -S R, so omega x v
    Jang = torch.stack(
        [
            Wb[..., 1] * T[..., 2] - Wb[..., 2] * T[..., 1],
            Wb[..., 2] * T[..., 0] - Wb[..., 0] * T[..., 2],
            Wb[..., 0] * T[..., 1] - Wb[..., 1] * T[..., 0],
        ],
        dim=-2,
    )  # (..., L, 3, A)
    J = torch.cat([eye3.expand(Jang.shape[:-1] + (3,)), Jang], dim=-1)
    return pts, J


def pose_limits_45():
    """(lower, upper) arrays over the 45 layout; +-inf where unbounded."""
    lo = np.full(N_POSE, -np.inf)
    hi = np.full(N_POSE, np.inf)
    t0 = 3 + N_JOINTS  # theta block start
    p0 = 3 + 2 * N_JOINTS  # psi block start

    def sym(i, lim):
        lo[i], hi[i] = -lim, lim

    sym(3, np.pi / 6)
    sym(t0 + 0, np.pi / 6)
    sym(4, np.pi / 6)
    sym(t0 + 1, np.pi / 6)
    sym(p0 + 1, np.pi / 6)
    sym(t0 + 2, np.pi / 6)
    sym(t0 + 3, np.pi / 6)
    sym(6, np.pi / 6)
    sym(p0 + 3, np.pi / 6)
    sym(t0 + 4, np.pi / 1.5)
    sym(p0 + 4, np.pi / 1.5)
    sym(t0 + 5, np.pi / 1.5)
    sym(p0 + 5, np.pi / 1.5)
    sym(t0 + 6, np.pi / 2)
    lo[t0 + 7], hi[t0 + 7] = -np.pi, 0.0
    sym(t0 + 8, np.pi / 2)
    lo[t0 + 9], hi[t0 + 9] = -np.pi, 0.0
    sym(t0 + 10, np.pi / 2)
    lo[t0 + 11], hi[t0 + 11] = 0.0, np.pi
    sym(t0 + 12, np.pi / 2)
    lo[t0 + 13], hi[t0 + 13] = 0.0, np.pi
    return lo, hi


def pose_limits_25():
    lo45, hi45 = pose_limits_45()
    return lo45[ACTIVE_IDX_ORDERED], hi45[ACTIVE_IDX_ORDERED]


def to_skeleton_dict():
    """The cheetah as a skeleton dictionary for the generic builder
    (``models.skeleton.build_skeleton_model``): rest positions are the
    zero-pose marker layout, dofs come from each marker's frame joint.

    The generic link FK composes each marker's rotation from its own
    part's dofs, a different factorisation from ``fk`` (where the eyes
    and nose ride the head frame), so the dict is for interchange and
    visualisation and carries ``fk_equivalent=False``: the builder
    refuses it unless called with ``allow_fk_mismatch=True``."""
    zero = fk(torch.zeros(N_POSE, dtype=torch.float64)).numpy()
    positions = {m: list(map(float, zero[i])) for i, m in enumerate(MARKERS)}
    joint_names = list(JOINTS)
    dof_map = {}
    for name, _base, frame_j, _off in MARKER_SPECS:
        _parent, hx, hy, hz = JOINTS[joint_names[frame_j]]
        dof_map[name] = [int(hx), int(hy), int(hz)]
    links = [
        ["nose", "neck_base"], ["neck_base", "spine"], ["spine", "tail_base"],
        ["tail_base", "tail1"], ["tail1", "tail2"],
        ["neck_base", "l_shoulder"], ["l_shoulder", "l_front_knee"],
        ["l_front_knee", "l_front_ankle"],
        ["neck_base", "r_shoulder"], ["r_shoulder", "r_front_knee"],
        ["r_front_knee", "r_front_ankle"],
        ["tail_base", "l_hip"], ["l_hip", "l_back_knee"], ["l_back_knee", "l_back_ankle"],
        ["tail_base", "r_hip"], ["r_hip", "r_back_knee"], ["r_back_knee", "r_back_ankle"],
        ["nose", "l_eye"], ["nose", "r_eye"],
    ]
    return dict(links=links, dofs=dof_map, positions=positions, markers=list(MARKERS),
                model="cheetah_fte", fk_equivalent=False)

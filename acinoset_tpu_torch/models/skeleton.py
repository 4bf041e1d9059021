"""Generic skeleton-dict forward kinematics on torch tensors, the
counterpart of acinoset_tpu.models.skeleton (the reference builder's
semantics, AcinoSet src/build.py:28-95).

A skeleton dict ``{links, dofs, positions, markers}`` compiles into an
FK over poses (..., n_pose) -> (..., R, 3) with any leading batch
dimensions, where the JAX package vmaps. Layout and semantics are the
JAX package's:
  * every part named in ``markers`` is promoted to 3 DoF;
  * local rotation = Rz^(has_z) @ Rx^(has_x) @ Ry^(has_y);
  * links compose in list order, child rotation R_child_local @
    R_parent_acc, child position pos_parent + R_parent_acc^T @ offset,
    last writer wins on a part that is revisited;
  * pose [x, y, z, phi_0..L-1, theta_0..L-1, psi_0..L-1], angle index =
    the part's position in the dofs dict.

``compat="tpu"`` (default) orders FK rows by the ``markers`` list and
has an analytic Jacobian: the tree form, or the DAG form when a part is
the child of two links. ``compat="reference"`` reproduces the
reference's flip-flopped offset rotation and its rows in link-walk
order against measurements in ``markers`` order; it has no analytic
Jacobian, and ``fk_and_jac_any`` builds one with ``torch.func.jacfwd``.

Every static table (link offsets, masks, column indices) is made once in
numpy at build time and put on a device once per (dtype, device): the
FK runs in every GN iteration and EKF frame, and a host copy there
would synchronise the stream.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..ops.rotations import mm3, mv3, mvT3, rot_x, rot_y, rot_z


def _local_rot(dofs_p, phi_i, theta_i, psi_i, eye):
    """Local DCM Rz^(hz) Rx^(hx) Ry^(hy) with identity factors elided."""
    hx, hy, hz = dofs_p
    R = None
    if hy:
        R = rot_y(theta_i)
    if hx:
        R = rot_x(phi_i) if R is None else mm3(rot_x(phi_i), R)
    if hz:
        R = rot_z(psi_i) if R is None else mm3(rot_z(psi_i), R)
    return eye if R is None else R


@dataclass
class SkeletonModel:
    """Compiled skeleton: FK function + pose-vector metadata."""

    fk: Callable  # (..., n_pose) -> (..., n_rows, 3)
    n_pose: int
    parts: List[str]
    markers: List[str]
    dofs: Dict[str, List[int]]
    #: indices into the pose vector that actually influence the FK
    active_idx: np.ndarray = field(default_factory=lambda: np.zeros(0, int))
    #: analytic (pts (..., R, 3), J (..., R, 3, n_pose)) in compat="tpu":
    #: ``fk_and_jac`` for a tree, ``fk_and_jac_dag`` when a part has two
    #: parents; None in compat="reference"
    fk_and_jac: Callable = None
    #: the ``build_skeleton_model`` arguments the model was built from: a
    #: pickled model is rebuilt from them (its functions are closures), so
    #: it can go to a worker process (``parallel.mesh``)
    source: Optional[tuple] = field(default=None, repr=False, compare=False)

    @property
    def n_markers(self) -> int:
        return len(self.markers)

    def __reduce__(self):
        if self.source is None:
            raise TypeError("this SkeletonModel was not built by build_skeleton_model and "
                            "cannot be pickled")
        return build_skeleton_model, self.source


def build_skeleton_model(
    skel_dict: Dict,
    promote_markers_to_3dof: bool = True,
    compat: str = "tpu",
    allow_fk_mismatch: bool = False,
) -> SkeletonModel:
    """Compile a skeleton dict into a SkeletonModel (see the module
    docstring). Dicts exported for interchange carry
    ``fk_equivalent=False`` (``models.cheetah.to_skeleton_dict``): their
    generic FK is not the flagship chain, and compiling one is refused
    unless ``allow_fk_mismatch=True``."""
    if compat not in ("tpu", "reference"):
        raise ValueError(f"unknown compat mode {compat!r}")
    if skel_dict.get("fk_equivalent") is False and not allow_fk_mismatch:
        raise ValueError(
            "this skeleton dict was exported for interchange/"
            f"visualization (model={skel_dict.get('model')!r}); its "
            "generic-FK evaluation does NOT reproduce the flagship "
            "kinematic chain. Solve with the flagship model instead "
            "(for 'cheetah_fte': acinoset_tpu_torch.models.cheetah + "
            "pipeline.fte/sweep), or pass allow_fk_mismatch=True to "
            "compile it anyway for visualization-grade use."
        )
    links = [list(l) for l in skel_dict["links"]]
    positions = {k: np.asarray(v, dtype=np.float64) for k, v in skel_dict["positions"].items()}
    dofs = {k: list(v) for k, v in skel_dict["dofs"].items()}
    markers = list(skel_dict.get("markers") or [])

    if promote_markers_to_3dof:
        for m in markers:
            dofs[m] = [1, 1, 1]

    parts = list(dofs.keys())
    part_idx = {p: i for i, p in enumerate(parts)}
    L = len(parts)
    n_pose = 3 + 3 * L

    # pose-dict insertion order (the reference's FK row order)
    walk_order: List[str] = []
    for link in links:
        for p in link:
            if p not in walk_order:
                walk_order.append(p)

    # FK row order: by name in tpu mode, pose-dict order in reference mode
    row_order = walk_order if compat == "reference" or not markers else markers
    Rrows = len(row_order)
    pairs = [(a, b) for a, b in (l for l in links if len(l) == 2)]

    # ---- static tables (numpy, once) ----
    tables = {
        "offsets": np.asarray([positions[b] - positions[a] for a, b in pairs],
                              np.float64).reshape(-1, 3),
        "eye": np.eye(3),
        "root_cols": np.arange(3),
    }
    device_tables: Dict[tuple, torch.Tensor] = {}

    def table(name, dtype, device):
        """A static table as a tensor on ``device``, made once per (name,
        dtype, device) and read only."""
        key = (name, dtype, device)
        if key not in device_tables:
            device_tables[key] = torch.as_tensor(tables[name], dtype=dtype, device=device)
        return device_tables[key]

    def split(x):
        return x[..., :3], x[..., 3:3 + L], x[..., 3 + L:3 + 2 * L], x[..., 3 + 2 * L:]

    def eye_like(x):
        return table("eye", x.dtype, x.device).expand(x.shape[:-1] + (3, 3))

    def local_rots(x):
        _root, phi, theta, psi = split(x)
        eye = eye_like(x)
        return {p: _local_rot(dofs[p], phi[..., part_idx[p]], theta[..., part_idx[p]],
                              psi[..., part_idx[p]], eye) for p in parts}

    def walk(x):
        """The link walk shared by the FK and the Jacobians: returns the
        FK rows, the local and the accumulated rotations, each linked
        child's parent rotation and the segment vectors in link order."""
        root = x[..., :3]
        offsets = table("offsets", x.dtype, x.device)
        loc = local_rots(x)
        rot = dict(loc)
        rot_i = {p: R.mT for p, R in rot.items()} if compat == "reference" else None
        pose: Dict[str, torch.Tensor] = {}
        Rpar: Dict[str, torch.Tensor] = {}
        segs: List[torch.Tensor] = []
        s = 0
        for link in links:
            if len(link) == 1:
                pose[link[0]] = root
                continue
            a, b = link
            if a not in pose:
                pose[a] = root
            off = offsets[s]
            s += 1
            parent_acc = rot[a]
            Rpar[b] = parent_acc
            rot[b] = mm3(rot[b], parent_acc)
            if compat == "reference":
                # src/build.py:78-80: the "_i" entry flip-flops between the
                # part's local rotation and its transpose each time the part
                # appears as a link child; offsets rotate by the parent's
                # "_i" entry as-is (not the cumulative inverse)
                rot_i[b] = rot_i[b].mT
                v = mv3(rot_i[a], off)
            else:
                v = mvT3(parent_acc, off)
            segs.append(v)
            pose[b] = pose[a] + v
        pts = torch.stack([pose.get(name, root) for name in row_order], dim=-2)
        return pts, loc, rot, Rpar, segs

    def fk(x):
        return walk(x)[0]

    # active pose indices: every dof flag set, and the root
    active = [0, 1, 2]
    angle_specs = []  # (kind, part name, pose column)
    for p in parts:
        i = part_idx[p]
        hx, hy, hz = dofs[p]
        if hx:
            active.append(3 + i)
            angle_specs.append(("phi", p, 3 + i))
        if hy:
            active.append(3 + L + i)
            angle_specs.append(("theta", p, 3 + L + i))
        if hz:
            active.append(3 + 2 * L + i)
            angle_specs.append(("psi", p, 3 + 2 * L + i))

    def phi_axis(q, theta, R):
        """World axis of phi at part q, rows of R^T e_k = rows of R:
        Ry(theta)^T x when q has a theta dof, else x."""
        if not dofs[q][1]:
            return R[..., 0, :]
        th = theta[..., part_idx[q]][..., None]
        return torch.cos(th) * R[..., 0, :] - torch.sin(th) * R[..., 2, :]

    def with_root_cols(J, dtype, device):
        """J (..., R, 3, n_pose) with identity root columns 0-2."""
        eye = table("eye", dtype, device).expand(J.shape[:-1] + (3,))
        return J.index_copy(-1, table("root_cols", torch.int64, device), eye)

    # ---- analytic tree Jacobian (compat="tpu", every part one parent):
    # each Euler angle at part j rotates everything below it about a world
    # axis omega that depends only on j, so d(R_a^T off)/d alpha = omega x
    # (R_a^T off) summed over the segments below j
    parent_of: Dict[str, str] = {}
    seg_id: Dict[str, int] = {}
    is_tree = True
    for s, (a, b) in enumerate(pairs):
        if b in parent_of:
            is_tree = False
        parent_of[b] = a
        seg_id[b] = s

    def part_chain(p):  # segments from part p up to the root
        out = []
        while p in seg_id:
            out.append(seg_id[p])
            p = parent_of[p]
        return out

    def anc_or_self(part):
        out = {part}
        while part in parent_of:
            part = parent_of[part]
            out.add(part)
        return out

    if is_tree:
        msa = np.zeros((Rrows, len(pairs), len(angle_specs)))
        for ri, name in enumerate(row_order):
            for s in part_chain(name):
                frame_anc = anc_or_self(pairs[s][0])
                for ai, (_k, p, _c) in enumerate(angle_specs):
                    if p in frame_anc:
                        msa[ri, s, ai] = 1.0
        tables["msa"] = msa
        tables["angle_cols"] = np.asarray([c for _k, _p, c in angle_specs], np.int64)

    def fk_and_jac(x):
        dtype, device = x.dtype, x.device
        pts, _loc, rot, Rpar, segs = walk(x)
        _root, _phi, theta, _psi = split(x)
        eye = eye_like(x)
        V = torch.stack(segs, dim=-2) if segs else x.new_zeros(x.shape[:-1] + (0, 3))
        omegas = []
        for kind, p, _c in angle_specs:
            Rp = Rpar.get(p, eye)
            if kind == "theta":
                omegas.append(Rp[..., 1, :])  # Rpar^T y_hat
            elif kind == "psi":
                omegas.append(rot[p][..., 2, :])  # R^T z_hat
            else:
                omegas.append(phi_axis(p, theta, Rp))
        W = (torch.stack(omegas, dim=-2) if omegas
             else x.new_zeros(x.shape[:-1] + (0, 3)))[..., None, :, :]
        T = torch.einsum("rsa,...sx->...rax", table("msa", dtype, device), V)
        # omega x v with components stacked on axis -2: (..., R, 3, A)
        Jang = torch.stack(
            [
                W[..., 1] * T[..., 2] - W[..., 2] * T[..., 1],
                W[..., 2] * T[..., 0] - W[..., 0] * T[..., 2],
                W[..., 0] * T[..., 1] - W[..., 1] * T[..., 0],
            ],
            dim=-2,
        )
        J = x.new_zeros(pts.shape + (n_pose,)).index_copy(
            -1, table("angle_cols", torch.int64, device), Jang)
        return pts, with_root_cols(J, dtype, device)

    # ---- DAG generalisation (compat="tpu", a part with two parents):
    # every accumulated rotation is a static ordered product of local
    # atoms (simulate the walk symbolically); for an angle occurrence in
    # that product the world axis is a row of the suffix product of the
    # atoms to its right, per (segment, occurrence)
    seqs = {p: (p,) for p in parts}
    pos_chain: Dict[str, tuple] = {p: () for p in parts}
    seg_frames_snap: List[tuple] = []
    for s_id, (a, b) in enumerate(pairs):
        seg_frames_snap.append(seqs[a])
        seqs[b] = seqs[b] + seqs[a]
        pos_chain[b] = pos_chain[a] + (s_id,)

    occ = []  # (segment, pose column, kind, part, suffix tail)
    for s, A in enumerate(seg_frames_snap):
        for i, q in enumerate(A):
            hx, hy, hz = dofs[q]
            qi = part_idx[q]
            if hz:
                occ.append((s, 3 + 2 * L + qi, "psi", q, A[i:]))
            if hx:
                occ.append((s, 3 + qi, "phi", q, A[i + 1:]))
            if hy:
                occ.append((s, 3 + L + qi, "theta", q, A[i + 1:]))
    if not is_tree:
        rows_chain = [set(pos_chain.get(name, ())) for name in row_order]
        Wmask = np.zeros((Rrows, len(occ)))
        col_onehot = np.zeros((len(occ), n_pose))
        for o, (s, col, _k, _q, _t) in enumerate(occ):
            col_onehot[o, col] = 1.0
            for ri in range(Rrows):
                if s in rows_chain[ri]:
                    Wmask[ri, o] = 1.0
        tables.update(Wmask=Wmask, col_onehot=col_onehot,
                      occ_seg=np.asarray([o[0] for o in occ], np.int64))
    tails_sorted = sorted({t for (*_a, t) in occ}, key=len)

    def fk_and_jac_dag(x):
        dtype, device = x.dtype, x.device
        pts, loc, _rot, _Rpar, segs = walk(x)
        _root, _phi, theta, _psi = split(x)
        eye = eye_like(x)
        # suffix products of local atoms, shared across occurrences
        memo = {(): eye}
        for t in tails_sorted:  # shortest first: inner tails usually hit
            if t in memo:
                continue
            if t[1:] in memo:
                memo[t] = mm3(loc[t[0]], memo[t[1:]])
            else:
                acc = eye
                for q in reversed(t):
                    acc = mm3(loc[q], acc)
                memo[t] = acc
        if not occ:
            return pts, with_root_cols(x.new_zeros(pts.shape + (n_pose,)), dtype, device)
        omegas = []
        for (_s, _col, kind, q, tail) in occ:
            Sfx = memo[tail]
            if kind == "psi":
                omegas.append(Sfx[..., 2, :])
            elif kind == "theta":
                omegas.append(Sfx[..., 1, :])
            else:
                omegas.append(phi_axis(q, theta, Sfx))
        Wo = torch.stack(omegas, dim=-2)  # (..., O, 3)
        V = torch.stack(segs, dim=-2)
        Cx = torch.linalg.cross(Wo, V[..., table("occ_seg", torch.int64, device), :], dim=-1)
        J = torch.einsum("ro,...ox,oa->...rxa", table("Wmask", dtype, device), Cx,
                         table("col_onehot", dtype, device))
        return pts, with_root_cols(J, dtype, device)

    # measurement labels: the markers list (data-loading order). In
    # reference mode FK rows are in walk order while the measurements stay
    # in markers order: positional association between the two reproduces
    # the reference's index mismatch (src/build.py:113-129 vs :232)
    return SkeletonModel(
        fk=fk,
        n_pose=n_pose,
        parts=parts,
        markers=(markers if markers else row_order),
        dofs=dofs,
        active_idx=np.asarray(sorted(active)),
        fk_and_jac=(
            fk_and_jac if (compat == "tpu" and is_tree)
            else fk_and_jac_dag if compat == "tpu"
            else None
        ),
        source=(skel_dict, promote_markers_to_3dof, compat, allow_fk_mismatch),
    )


def fk_and_jac_any(model: SkeletonModel) -> Callable:
    """The model's FK with its Jacobian, for every skeleton: the analytic
    ``model.fk_and_jac`` where there is one, else ``torch.func.jacfwd``
    over the FK of one pose under ``torch.func.vmap`` over the flattened
    leading dimensions (the FK alone, never through the cameras).
    poses (..., n_pose) -> (pts (..., R, 3), J (..., R, 3, n_pose))."""
    if model.fk_and_jac is not None:
        return model.fk_and_jac
    fk, n_pose = model.fk, model.n_pose

    def one(pose):
        pts = fk(pose)
        return pts, pts

    per_pose = torch.func.vmap(torch.func.jacfwd(one, has_aux=True))

    def fkj(pose):
        lead = pose.shape[:-1]
        J, pts = per_pose(pose.reshape(-1, n_pose))
        return pts.reshape(*lead, *pts.shape[1:]), J.reshape(*lead, *J.shape[1:])

    return fkj


def generic_pose_limits(model: SkeletonModel,
                        limit: float = np.pi / 2) -> Tuple[np.ndarray, np.ndarray]:
    """Blanket +-pi/2 limits on all angle states (src/build.py:263-266);
    root translation unbounded."""
    lo = np.full(model.n_pose, -np.inf)
    hi = np.full(model.n_pose, np.inf)
    lo[3:] = -limit
    hi[3:] = limit
    return lo, hi

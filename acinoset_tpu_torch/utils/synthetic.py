"""Synthetic multi-camera cheetah runs (tests and chip_smoke.py), the
counterpart of acinoset_tpu.utils.synthetic: same cameras, trajectory
and numpy RNG call order, with the port's FK and projection evaluated
on the CPU in float64, so the data equal the JAX package's. Also
synthetic checkerboard views for calibration, by the rules of the
JAX package's calibration tests (tests/test_calib.py,
tests/test_pinhole_calib.py), and rendered calibration frames
(``write_png``, from ``utils.png``), to drive calibration from images;
box-only MP4 files, which declare a video's size, frame rate and frame
count and hold no frame (``write_box_mp4``); and camera footage as mp4v
video: a textured static scene, a textured patch moving by whole and
half pixels, and the markers' projections drawn over it
(``scene_frames``, ``write_scene_mp4``)."""
import json
import os
import struct

import numpy as np
import torch

from ..models import cheetah
from ..ops import camera as cam_ops
from ..ops.rotations import rodrigues
from ..pipeline import data as data_io
from ..pipeline.data import create_board_object_pts
from .png import write_png  # noqa: F401  (the rendered frames' writer)


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


def make_synthetic_run_dir(root_dir, n_cams: int = 4, N: int = 40, fps: float = 90.0,
                           seed: int = 0, cam_res=(2704, 1520), noise_px: float = 1.0):
    """Write a run directory in the reference's layout under ``root_dir``
    (``2019_03_09/synthetic/run/dlc/cam{c}DLC.h5``, the scene
    ``2019_03_09/synthetic/extrinsic_calib/{n}_cam_scene_sba.json`` and
    the ``video_info.json`` sidecar), the files written by the port's own
    writers. Returns (run_dir, cams, X_true, pts3d), the data equal to
    the JAX package's ``make_synthetic_run_dir`` on the same arguments."""
    run = os.path.join(root_dir, "2019_03_09", "synthetic", "run")
    dlc = os.path.join(run, "dlc")
    os.makedirs(dlc, exist_ok=True)
    cams = ring_cameras(n_cams=n_cams, res=cam_res)
    k, d, r, t, res = cams
    X_true = cheetah_gallop(N=N, fps=fps)
    pixels, likelihood, pts3d = render_measurements(
        X_true, cams, noise_px=noise_px, outlier_frac=0.01, bad_lik_frac=0.02, seed=seed,
    )
    for c in range(n_cams):
        data_io.save_dlc_points_h5(os.path.join(dlc, f"cam{c + 1}DLC.h5"), pixels[c],
                                   likelihood[c], cheetah.get_markers())
    scene_dir = os.path.join(os.path.dirname(run), "extrinsic_calib")
    data_io.save_scene(os.path.join(scene_dir, f"{n_cams}_cam_scene_sba.json"),
                       k, d.reshape(-1, 4, 1), r, t, res)
    with open(os.path.join(run, "video_info.json"), "w") as f:
        json.dump({"resolution": list(res), "fps": fps, "tot_frames": N}, f)
    return run, cams, X_true, pts3d


# ---- checkerboard views for calibration ----

#: tests/test_calib.py's synthetic GoPro-like fisheye at 2704 x 1520
FISHEYE_K = np.array([[700.0, 0, 1352], [0, 700.0, 760], [0, 0, 1.0]])
FISHEYE_D = np.array([0.04, 0.005, -0.006, 0.001])
FISHEYE_RES = (2704, 1520)
#: tests/test_calib.py::test_stereo_pair_synthetic's pair: X_c2 = R X_c1 + t
PAIR_RVEC = np.array([0.05, -0.35, 0.08])
PAIR_T = np.array([1.2, 0.1, 0.25])
#: board poses in the first camera's frame, tests/test_calib.py's rule
FISHEYE_POSES = dict(rot_scale=0.4, t_range=((-0.5, 0.5), (-0.3, 0.3), (2.0, 5.0)))
#: tests/test_pinhole_calib.py's camera at 1280 x 720 and its rules:
#: intrinsics views, and pair views
PINHOLE_K = np.array([[820.0, 0, 640.0], [0, 810.0, 360.0], [0, 0, 1]])
PINHOLE_RES = (1280, 720)
PINHOLE_POSES = dict(rot_scale=0.35, t_range=((-0.3, 0.3), (-0.2, 0.2), (0.8, 2.0)))
PINHOLE_PAIR_POSES = dict(rot_scale=0.3, t_range=((-0.3, 0.3), (-0.2, 0.2), (1.2, 2.5)))
PINHOLE_D = np.array([0.08, -0.03, 0.0005, -0.001, 0.005, 0.0, 0.0, 0.0])
PINHOLE_PAIR_D = np.array([0.05, -0.02, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0])
PINHOLE_PAIR_RVEC = np.array([0.04, -0.3, 0.06])
PINHOLE_PAIR_T = np.array([0.8, 0.05, 0.15])


def _rot(rvec):
    return rodrigues(torch.as_tensor(rvec, dtype=torch.float64)).numpy()


def board_views(rng, n_views, cams, rot_scale, t_range, project=cam_ops.project_points_fisheye):
    """Views of the (9, 6) board with 0.04 m squares seen by one or more
    cameras. Per view, in this RNG order: a board pose in the first
    camera's frame (rotation vector ~ N(0, rot_scale), translation
    uniform in t_range), then for each camera (K, D, R, t) of ``cams``
    (R, t: the pose relative to the first camera) the projected corners
    plus N(0, 0.2 px) noise. Returns (obj (M, 3) float32, views
    (len(cams), n_views, M, 2))."""
    obj = create_board_object_pts((9, 6), 0.04)
    obj_t = torch.as_tensor(obj, dtype=torch.float64)
    out = np.zeros((len(cams), n_views, len(obj), 2))
    for f in range(n_views):
        Rb = _rot(rng.normal(scale=rot_scale, size=3))
        tb = np.array([rng.uniform(*t_range[0]), rng.uniform(*t_range[1]),
                       rng.uniform(*t_range[2])])
        for c, (K, D, R, t) in enumerate(cams):
            pix = project(obj_t, K, D, R @ Rb, R @ tb + t).numpy()
            out[c, f] = pix + rng.normal(scale=0.2, size=pix.shape)
    return obj, out


def pinhole_views():
    """tests/test_pinhole_calib.py's calibrate_camera input: 12 views of
    PINHOLE_K with PINHOLE_D by its rule, 0.2 px noise, seed 0. Returns
    (obj, views (12, M, 2))."""
    obj, v = board_views(np.random.default_rng(0), 12,
                         [(PINHOLE_K, PINHOLE_D, np.eye(3), np.zeros(3))],
                         project=cam_ops.project_points_pinhole, **PINHOLE_POSES)
    return obj, v[0]


def pinhole_pair_views():
    """tests/test_pinhole_calib.py's pinhole pair: 8 shared views, seed
    11, the second camera at (PINHOLE_PAIR_RVEC, PINHOLE_PAIR_T) from the
    first. Returns (obj, p1, p2)."""
    obj, v = board_views(np.random.default_rng(11), 8,
                         [(PINHOLE_K, PINHOLE_PAIR_D, np.eye(3), np.zeros(3)),
                          (PINHOLE_K, PINHOLE_PAIR_D, _rot(PINHOLE_PAIR_RVEC), PINHOLE_PAIR_T)],
                         project=cam_ops.project_points_pinhole, **PINHOLE_PAIR_POSES)
    return obj, v[0], v[1]


def chained_rig(n_cams, world_r1):
    """World extrinsics (R (n, 3, 3), T (n, 3, 1)) of cameras each related
    to the one before by (rodrigues(PAIR_RVEC), PAIR_T), the first at
    (world_r1, 0), composed as the reference chains stereo pairs."""
    r = _rot(PAIR_RVEC)
    R, T = [np.asarray(world_r1, np.float64)], [np.zeros((3, 1))]
    for _ in range(n_cams - 1):
        R.append(r @ R[-1])
        T.append(r @ T[-1] + PAIR_T.reshape(3, 1))
    return np.stack(R), np.stack(T)


def chained_pair_views(rng, n_cams, n_views, reversed_views=0):
    """Board views shared by each adjacent pair of chained_rig's cameras
    (FISHEYE_K, FISHEYE_D): n_views a pair by board_views' fisheye rule in
    the pair's first camera, named "{pair}_{view}.png", the second
    camera's corners reversed (the detector's 180-degree ambiguity) in
    the first ``reversed_views`` views of each pair. Returns (obj,
    img_pts_arr, fnames_arr, reversed names): per camera its (F_c, M, 2)
    corners and file names, in the order of calibrate_pairwise_
    extrinsics' inputs."""
    K, D = FISHEYE_K, FISHEYE_D
    pair = [(K, D, np.eye(3), np.zeros(3)), (K, D, _rot(PAIR_RVEC), PAIR_T)]
    img = [[] for _ in range(n_cams)]
    names = [[] for _ in range(n_cams)]
    rev = []
    for i in range(n_cams - 1):
        obj, views = board_views(rng, n_views, pair, **FISHEYE_POSES)
        for f in range(n_views):
            name = f"{i}_{f}.png"
            second = views[1, f][::-1] if f < reversed_views else views[1, f]
            rev += [name] if f < reversed_views else []
            img[i].append(views[0, f])
            names[i].append(name)
            img[i + 1].append(second)
            names[i + 1].append(name)
    return obj, [np.array(v) for v in img], names, rev


# ---- rendered calibration frames ----

#: board grey levels: black and white squares, the white margin around
#: them, and the mid-grey background
BLACK, WHITE, BACKGROUND = 30.0, 225.0, 128.0


def board_poses(rng, n_views, rot_scale, t_range):
    """Board poses (R (3, 3), t (3,)) in a camera's frame by board_views'
    rule: rotation vector ~ N(0, rot_scale), translation uniform in
    t_range."""
    poses = []
    for _ in range(n_views):
        R = _rot(rng.normal(scale=rot_scale, size=3))
        t = np.array([rng.uniform(*t_range[0]), rng.uniform(*t_range[1]),
                      rng.uniform(*t_range[2])])
        poses.append((R, t))
    return poses


def held_board_poses(rng, n_views, tilt, t_range, spin=0.3, board_shape=(9, 6), square=0.04):
    """Board poses (R (3, 3), t (3,)) as a person holds a board up to a
    camera: the board's centre uniform in t_range (camera frame), its
    face turned to the camera, then tilted by an angle uniform in
    ``tilt`` (rad) about a random axis in its plane and turned in its
    plane by up to +-spin."""
    centre = np.array([(board_shape[0] - 1) / 2, (board_shape[1] - 1) / 2, 0.0]) * square
    poses = []
    for _ in range(n_views):
        c = np.array([rng.uniform(*t_range[0]), rng.uniform(*t_range[1]),
                      rng.uniform(*t_range[2])])
        phi, angle, turn = rng.uniform(0, 2 * np.pi), rng.uniform(*tilt), rng.uniform(-spin, spin)
        z = c / np.linalg.norm(c)  # the board's normal, along the line of sight
        x = np.cross([0.0, 1.0, 0.0], z)
        x /= np.linalg.norm(x)
        facing = np.stack([x, np.cross(z, x), z], axis=1)
        R = (facing @ _rot(angle * np.array([np.cos(phi), np.sin(phi), 0.0]))
             @ _rot(np.array([0.0, 0.0, turn])))
        poses.append((R, c - R @ centre))
    return poses


def fisheye_rays(K, D, res, device, supersample=2):
    """Camera-frame rays (H, W, S, 3) float64 through the supersample^2
    sample points of each pixel (pixel centres at integer coordinates),
    by the port's undistort_points_fisheye."""
    W, H = res
    off = (torch.arange(supersample, dtype=torch.float64) + 0.5) / supersample - 0.5
    sy, sx = torch.meshgrid(off, off, indexing="ij")
    v, u = torch.meshgrid(torch.arange(H, dtype=torch.float64),
                          torch.arange(W, dtype=torch.float64), indexing="ij")
    pix = torch.stack([u[..., None] + sx.reshape(-1), v[..., None] + sy.reshape(-1)], dim=-1)
    ab = cam_ops.undistort_points_fisheye(pix.to(device), K, D)
    return torch.cat([ab, torch.ones_like(ab[..., :1])], dim=-1)


def render_board_frame(rays, R, t, generator, noise=2.0, margin=2, board_shape=(9, 6),
                       square=0.04):
    """One RGB uint8 frame (H, W, 3) on the rays' device of the board at
    pose (R, t) (board -> camera) seen along ``rays`` (fisheye_rays): each
    sample ray meets the board plane, is shaded black or white by its
    square, white in a margin ``margin`` squares wide, mid-grey elsewhere
    (or behind the camera); samples are averaged a pixel and N(0, noise)
    grey levels added a channel from ``generator``. A one-square margin
    leaves the detector's lattice a row or a column off the board on
    some frames (chip_smoke.images_pose_survey); two do not."""
    R = torch.as_tensor(R, dtype=torch.float64, device=rays.device)
    t = torch.as_tensor(t, dtype=torch.float64, device=rays.device).reshape(3)
    n = R[:, 2]  # the board's normal in the camera frame
    s = torch.dot(n, t) / (rays @ n)  # distance along each ray to the plane
    front = s > 0
    hit = rays * s[..., None] - t  # camera frame, from the board's origin
    bx, by = hit @ R[:, 0] / square, hit @ R[:, 1] / square  # in squares
    cols, rows = board_shape[0] + 1, board_shape[1] + 1  # squares around the inner corners
    on_squares = front & (bx >= -1) & (bx < cols - 1) & (by >= -1) & (by < rows - 1)
    on_margin = (front & (bx >= -1 - margin) & (bx < cols - 1 + margin) & (by >= -1 - margin)
                 & (by < rows - 1 + margin))
    dark = (torch.floor(bx) + torch.floor(by)) % 2 == 0
    grey = torch.where(on_margin, WHITE, BACKGROUND)
    grey = torch.where(on_squares & dark, BLACK, grey).mean(dim=-1)
    rgb = grey[..., None] + noise * torch.randn(grey.shape + (3,), generator=generator,
                                                dtype=torch.float64, device=rays.device)
    return torch.round(rgb).clamp(0, 255).to(torch.uint8)


# ---- box-only videos ----


def _box(kind, payload):
    return struct.pack(">I4s", 8 + len(payload), kind) + payload


def _full_box(kind, payload):
    return _box(kind, bytes(4) + payload)  # version 0, no flags


def write_box_mp4(path, size, fps, n_frames):
    """An MP4 file whose one video track declares ``size`` (width,
    height), ``fps`` and ``n_frames`` frames in its boxes (ftyp, then
    moov/trak with tkhd, mdhd, hdlr, and stbl's stsd, stts, stsz, stco)
    and holds no sample: what ``utils.mp4.video_info`` reads, and no
    decoder could play. The timescale is fps x 1000 ticks a second, one
    frame 1000 ticks, so a rate with three decimals reads back exactly."""
    width, height = (int(v) for v in size)
    timescale = int(round(float(fps) * 1000))
    tkhd = struct.pack(">III4xI", 0, 0, 1, n_frames * 1000) + bytes(52) + struct.pack(
        ">II", width << 16, height << 16)
    mdhd = struct.pack(">IIII", 0, 0, timescale, n_frames * 1000) + bytes(4)
    hdlr = struct.pack(">I4s12x", 0, b"vide") + b"\x00"
    # VisualSampleEntry: reserved, data_reference_index, 16 bytes, the size, the rest
    entry = (bytes(6) + struct.pack(">H", 1) + bytes(16) + struct.pack(">HH", width, height)
             + bytes(50))
    stbl = _box(b"stbl", _full_box(b"stsd", struct.pack(">I", 1) + _box(b"mp4v", entry))
                + _full_box(b"stts", struct.pack(">III", 1, n_frames, 1000))
                + _full_box(b"stsz", struct.pack(">II", 0, n_frames) + bytes(4 * n_frames))
                + _full_box(b"stco", struct.pack(">I", 0)))
    mdia = _box(b"mdia", _full_box(b"mdhd", mdhd) + _full_box(b"hdlr", hdlr)
                + _box(b"minf", stbl))
    moov = _box(b"moov", _box(b"trak", _full_box(b"tkhd", tkhd) + mdia))
    with open(path, "wb") as f:
        f.write(_box(b"ftyp", b"isom" + bytes(4) + b"isommp41") + moov)
    return path


# ---- camera footage ----

#: the moving patch's speed, pixels a frame (x, y): whole and half pixels
PATCH_SPEED = (1.5, 0.5)


def _texture(x, y, phase):
    """A smooth BGR texture of float pixel coordinates (broadcast)."""
    return torch.stack([
        128 + 60 * torch.sin(x / 23.0 + phase) * torch.cos(y / 17.0),
        128 + 50 * torch.sin((x + 2 * y) / 41.0 + 2 * phase),
        128 + 70 * torch.cos(x / 31.0 - y / 13.0 + 3 * phase)], -1)


def scene_frames(size, n_frames, markers_px=None, seed=0, device="cpu", sensor_noise=0.0):
    """Frames (uint8 BGR (H, W, 3) tensors on ``device``) of a static
    camera: a smooth texture with frozen noise (a seeded numpy stream,
    +-12 levels over 4 x 4 pixel cells), a patch of another texture, an
    eighth of the frame wide and a sixth high, moving PATCH_SPEED pixels a
    frame (its content resampled at the sub-pixel offset), with
    sensor_noise > 0 a camera's temporal noise (Gaussian, that many levels
    of standard deviation, drawn anew for every pixel, channel and frame
    from a torch generator on ``device`` seeded with ``seed``), and, with
    markers_px (N, L, 2), frame n's projected markers drawn over it as
    labelled videos draw them (pipeline.video.draw_labels: the cheetah
    skeleton and a dot a marker)."""
    from ..pipeline.plots import CHEETAH_LINKS
    from ..pipeline.video import _frame_labels, draw_labels, marker_colours

    W, H = (int(v) for v in size)
    dev = torch.device(device)
    rng = np.random.default_rng(seed)
    y = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
    x = torch.arange(W, dtype=torch.float32, device=dev)[None, :]
    noise = torch.from_numpy(rng.uniform(-12, 12, ((H + 3) // 4, (W + 3) // 4, 3))
                             .astype(np.float32)).to(dev)
    noise = noise.repeat_interleave(4, 0).repeat_interleave(4, 1)[:H, :W]
    bg = (_texture(x, y, 0.0) + noise).round().clamp(0, 255).to(torch.uint8)
    pw, ph = max(W // 8, 1), max(H // 6, 1)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    links, colours = [], None
    if markers_px is not None:
        markers = cheetah.get_markers()
        links = [(markers.index(a), markers.index(b)) for a, b in CHEETAH_LINKS]
        colours = np.array(marker_colours(len(markers)), np.uint8)
    for n in range(n_frames):
        frame = bg.clone()
        ox, oy = PATCH_SPEED[0] * n, PATCH_SPEED[1] * n
        x0 = int(W // 4 + ox) % max(W - pw, 1)
        y0 = int(H // 3 + oy) % max(H - ph, 1)
        px = torch.arange(x0, x0 + pw, dtype=torch.float32, device=dev)[None, :] - ox
        py = torch.arange(y0, y0 + ph, dtype=torch.float32, device=dev)[:, None] - oy
        frame[y0:y0 + ph, x0:x0 + pw] = _texture(2.1 * px, 1.7 * py, 1.0).round().clamp(
            0, 255).to(torch.uint8)
        if sensor_noise > 0:
            noisy = frame + sensor_noise * torch.randn((H, W, 3), generator=gen, device=dev)
            frame = noisy.round().clamp(0, 255).to(torch.uint8)
        if markers_px is not None and n < len(markers_px):
            pts = np.concatenate([markers_px[n], np.ones((len(markers_px[n]), 1))], 1)
            segments, dots, which = _frame_labels(pts, links, 1.0, True)
            draw_labels(frame, segments, dots, colours[which])
        yield frame


def write_scene_mp4(path, size, fps, n_frames, markers_px=None, seed=0, device="cpu"):
    """``scene_frames`` written as an mp4v video by the port's writer
    (utils.mpeg4, on ``device``). Returns path."""
    from . import mpeg4

    with mpeg4.Writer(path, size, fps, device) as writer:
        for frame in scene_frames(size, n_frames, markers_px, seed, device):
            writer.write(frame)
    return path

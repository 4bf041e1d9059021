"""Device mesh and sharding for multi-trajectory solves, the counterpart
of acinoset_tpu.parallel.mesh.

A mesh is a 1-D (data,) or 2-D (data, model) array of torch devices:

  * ``data``  - trajectories: each data row solves its own slice of the
    batch, with no communication until the results are gathered;
  * ``model`` - cameras: each shard of a data row holds the row's
    trajectories and its own cameras, projects only those, and on every
    Gauss-Newton iteration the camera-partial sums (the objective's
    measurement term, the per-marker cores or H and g, also in the
    status pass and the posterior) are summed over the row
    (``fte_solve``'s ``camera_sum``).

Execution model: one worker process per data row, one Python thread per
shard of a row. The port is host-bound (about 19k eager ops a flagship
solve at 19.5-62 us of host time a device op), so the shards need issuing
threads of their own; but every PyTorch op releases and retakes the GIL,
and threads of one process that all issue small ops hand the GIL over at
every op: on a host of four H100s (700 W), a data mesh with a thread per
card took 2.45 s where one card took 0.146 s (PERF.md, section 6). So each
data row runs in a process of its own (``run_rows``: spawned once, kept
for the process's life, stopped at exit or by ``shutdown_workers``),
which rebuilds nothing: the work is a module's function, and the
measurement functions pickle (``pipeline.ekf.RigFunction`` over the
cheetah's FK; a skeleton model pickles as its dict). A mesh of one data
row starts no process, and one shard no thread: a one-shard mesh calls
``fte_solve`` on its device directly.

The shards of a row share a process, and its camera sums are in-process
adds (``TRANSPORT``): each shard puts its partial in a slot, and after a
barrier every shard adds all the slots in shard order on its own device
(a peer copy between cards), so every shard of the row holds the same
bits and takes the same step. No process group, NCCL or gloo, is
started: rows never communicate. CPU shards of a row share the host's
cores, so their threads take turns (``run_shards``).

``make_mesh`` takes the visible CUDA devices unless given devices; it
raises where there are fewer than asked for and never drops to the CPU.
CPU shards exist only when the caller passes CPU devices, as the tests
and the dry run (``entry.dryrun_multichip``) do.
"""
from __future__ import annotations

import atexit
import multiprocessing
import pickle
import threading
import traceback
from contextlib import nullcontext
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.precision import f32_matmuls

#: how the camera-partial sums travel between the shards of a data row
TRANSPORT = ("in-process adds across the row's threads (peer copies between cards); "
             "one worker process a data row")


class Mesh:
    """Devices as a (data[, model]) array with its axis names."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        if devices.ndim != len(self.axis_names):
            raise ValueError(f"{devices.ndim}-d devices for axes {self.axis_names}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def grid(self) -> np.ndarray:
        """The devices as (data, model), model 1 for a 1-D mesh."""
        return self.devices.reshape(self.devices.shape[0], -1)

    def __repr__(self):
        return f"Mesh({self.shape}, devices={[str(d) for d in self.devices.flat]})"


def cuda_devices() -> List[torch.device]:
    """Every visible CUDA device, in order."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _device_array(devs, shape) -> np.ndarray:
    arr = np.empty(len(devs), dtype=object)
    for i, d in enumerate(devs):
        arr[i] = d
    return arr.reshape(shape)


def make_mesh(
    n_devices: Optional[int] = None,
    model_axis: bool = True,
    devices=None,
    model_size: Optional[int] = None,
) -> Mesh:
    """A mesh over the first ``n_devices`` devices (all, when None).

    A 2-D (data, model) layout when ``n_devices`` is even and
    ``model_axis`` is requested, else 1-D (data,). ``model_size`` pins the
    model extent (it must divide the device count); the default is 2.
    The devices are the visible CUDA devices unless ``devices`` is given
    (for example ``[torch.device("cpu")] * 8``: eight CPU shards). Raises
    where fewer devices are present than asked for."""
    if devices is None:
        devs = cuda_devices()
        if not devs:
            raise RuntimeError("no CUDA device is available; pass devices=[torch.device('cpu')]"
                               " * n for CPU shards")
    else:
        devs = [torch.device(d) for d in devices]
    if n_devices is not None and len(devs) < n_devices:
        raise ValueError(f"need {n_devices} devices, have {len(devs)}")
    devs = devs[: n_devices or len(devs)]
    n = len(devs)
    if n == 0:
        raise ValueError("a mesh needs at least one device")
    if model_size is not None and model_size > 1:
        if not model_axis:
            raise ValueError("model_size given but model_axis=False")
        if n % model_size:
            raise ValueError(f"model_size {model_size} does not divide {n} devices")
        return Mesh(_device_array(devs, (n // model_size, model_size)), ("data", "model"))
    if model_axis and model_size != 1 and n % 2 == 0 and n > 1:
        return Mesh(_device_array(devs, (n // 2, 2)), ("data", "model"))
    return Mesh(_device_array(devs, (n,)), ("data",))


def batch_spec(mesh: Mesh, shard_cameras: bool = True) -> Tuple[tuple, tuple, tuple]:
    """The axis each dimension of (X0 (B, N, P), meas (B, N, C, L, 2),
    w (B, N, C, L)) is split over, None where it is whole."""
    model = "model" if ("model" in mesh.axis_names and shard_cameras) else None
    return ("data", None, None), ("data", None, model, None, None), ("data", None, model, None)


@dataclass
class ShardedBatch:
    """A trajectory batch placed on a mesh: ``parts[i][j]`` is shard (i,
    j)'s (X0, meas, w) on its device, holding the batch rows of data row
    i and the rig cameras ``cams[j]``. Without split cameras only the
    first shard of each row holds (and solves) its rows."""

    mesh: Mesh
    parts: List[List[tuple]]
    cams: List[slice]
    batch: int

    @property
    def split_cameras(self) -> bool:
        return len(self.cams) > 1


def shard_batch(mesh: Mesh, X0, meas, w, shard_cameras: bool = True) -> ShardedBatch:
    """Place a trajectory batch on the mesh: trajectories split over
    'data', cameras over 'model' when ``shard_cameras``. The batch must
    divide over the data extent (``pad_batch`` first) and the cameras
    over the model extent."""
    return _split(mesh, X0, meas, w, shard_cameras, place=True)


def _split(mesh, X0, meas, w, shard_cameras, place):
    """``shard_batch``, its parts on their devices, or left where they
    are (``place=False``) for a worker process to move."""
    grid = mesh.grid()
    n_data, n_model = grid.shape
    X0, meas, w = (torch.as_tensor(a) for a in (X0, meas, w))
    B, C = X0.shape[0], meas.shape[2]
    if B % n_data:
        raise ValueError(f"a batch of {B} does not divide over {n_data} data shards; "
                         "pad it first (pad_batch)")
    split = shard_cameras and n_model > 1
    if split and C % n_model:
        raise ValueError(f"{C} cameras do not divide over {n_model} model shards")
    cams = ([slice(j * C // n_model, (j + 1) * C // n_model) for j in range(n_model)]
            if split else [slice(None)])
    b = B // n_data
    parts = []
    for i in range(n_data):
        rows = slice(i * b, (i + 1) * b)
        parts.append([
            tuple(t.to(grid[i, j]) if place else t
                  for t in (X0[rows], meas[rows, :, cams[j]].contiguous(),
                            w[rows, :, cams[j]].contiguous()))
            for j in range(len(cams))
        ])
    return ShardedBatch(mesh, parts, cams, B)


def pad_batch(arrs: Sequence, multiple: int):
    """Pad the leading (batch) dimension of every array (numpy or tensor)
    to a multiple; returns (padded arrays, original batch size). The
    padding repeats the first element, so the solver stays well defined
    on padded rows."""
    B = arrs[0].shape[0]
    Bp = ((B + multiple - 1) // multiple) * multiple
    if Bp == B:
        return list(arrs), B
    out = []
    for a in arrs:
        if torch.is_tensor(a):
            out.append(torch.cat([a, a[:1].expand(Bp - B, *a.shape[1:])], dim=0))
        else:
            out.append(np.concatenate([a, np.repeat(a[:1], Bp - B, axis=0)], axis=0))
    return out, B


class _CameraGroup:
    """The shards of one data row: sums a camera-partial tensor over them,
    in shard order on each shard's own device. ``turn`` is the row's CPU
    turn (``run_shards``), let go while a CPU shard waits at a barrier."""

    def __init__(self, n: int, turn: threading.Lock):
        self.n = n
        self.turn = turn
        self.slots: List[Optional[torch.Tensor]] = [None] * n
        self.barrier = threading.Barrier(n)

    def wait(self, device):
        if device.type != "cpu":
            self.barrier.wait()
            return
        self.turn.release()
        try:
            self.barrier.wait()
        finally:
            self.turn.acquire()

    def summer(self, rank: int) -> Callable:
        def camera_sum(t):
            self.slots[rank] = t
            self.wait(t.device)
            total = self.slots[0].to(t.device)
            for k in range(1, self.n):
                total = total + self.slots[k].to(t.device)
            self.wait(t.device)  # every shard has read every slot
            return total

        return camera_sum


def _on_device(device):
    return torch.cuda.device(device) if device.type == "cuda" else nullcontext()


def run_shards(devices: Sequence[torch.device], work: Callable) -> List:
    """``work(j, camera_sum)`` for every shard j of one data row, on the
    shard's device ``devices[j]``, one thread each; ``camera_sum`` sums a
    tensor over the row's shards (None for one shard, which runs in the
    calling thread). The first error of any shard is raised after every
    thread has ended."""
    n = len(devices)
    if n == 1:
        return [work(0, None)]
    # CPU shards take turns: they share the host's cores, and threads that
    # all run small eager ops hand the GIL over at every op (each PyTorch
    # op releases it), which made eight CPU shards 3-10x slower than
    # solving them one after another. A CPU shard holds the row's turn
    # while it runs and lets it go while it waits for the other shards.
    turn = threading.Lock()
    group = _CameraGroup(n, turn)
    results: List = [None] * n
    errors: List[BaseException] = []

    def body(j):
        try:
            with _on_device(devices[j]), (turn if devices[j].type == "cpu" else nullcontext()):
                results[j] = work(j, group.summer(j))
        except BaseException as e:  # noqa: BLE001 - re-raised in the calling thread
            errors.append(e)
            group.barrier.abort()

    threads = [threading.Thread(target=body, args=(j,), name=f"shard-{j}", daemon=True)
               for j in range(n)]
    # pin the matmul precision once for every thread (fte_solve's own pin
    # then saves and restores the same settings)
    with f32_matmuls():
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    if errors:
        raise next((e for e in errors if not isinstance(e, threading.BrokenBarrierError)),
                   errors[0])
    return results


class _Worker:
    """A spawned process that runs one piece of work at a time:
    ``fn(*args)`` sent down a pipe, the result (or the traceback) sent
    back."""

    def __init__(self):
        ctx = multiprocessing.get_context("spawn")
        self.conn, child = ctx.Pipe()
        self.proc = ctx.Process(target=_worker_main, args=(child, torch.get_num_threads()),
                                daemon=True)
        self.proc.start()
        child.close()

    def submit(self, payload: bytes):
        self.conn.send_bytes(payload)

    def result(self):
        try:
            ok, value = _loads(self.conn.recv_bytes())
        except EOFError:
            raise RuntimeError(f"mesh worker process {self.proc.pid} ended") from None
        if not ok:
            raise RuntimeError(f"in mesh worker process {self.proc.pid}:\n{value}")
        return value

    def close(self):
        try:
            self.conn.send_bytes(pickle.dumps(None))
        except OSError:
            pass
        self.proc.join(timeout=10)
        if self.proc.is_alive():
            self.proc.terminate()
            self.proc.join()
        self.conn.close()


def _worker_main(conn, n_threads):
    # tensors travel by value as numpy arrays (``_dumps``), not through
    # shared-memory files as multiprocessing's own pickler sends them
    torch.set_num_threads(n_threads)
    while True:
        try:
            msg = _loads(conn.recv_bytes())
        except EOFError:
            return
        if msg is None:
            return
        fn, args = msg
        try:
            reply = (True, fn(*args))
        except BaseException:  # noqa: BLE001 - sent to the calling process
            reply = (False, traceback.format_exc())
        conn.send_bytes(_dumps(reply))


class _Wire:
    """A CPU tensor as a numpy array on its way through a pipe: numpy
    arrays pickle as one copy, tensors through torch's serializer."""

    def __init__(self, t):
        self.a = t.numpy()

    def tensor(self):
        return torch.from_numpy(self.a)


def _wire(obj, out: bool):
    """Tensors, on any device, to ``_Wire``s on the CPU (``out``), or
    back (bfloat16, which numpy lacks, goes as a CPU tensor)."""
    if out and torch.is_tensor(obj):
        t = obj.cpu()
        return t if t.dtype == torch.bfloat16 else _Wire(t)
    if not out and isinstance(obj, _Wire):
        return obj.tensor()
    if isinstance(obj, (tuple, list)):
        return type(obj)(_wire(o, out) for o in obj)
    if isinstance(obj, dict):
        return {k: _wire(v, out) for k, v in obj.items()}
    return obj


def _dumps(obj) -> bytes:
    return pickle.dumps(_wire(obj, True), protocol=pickle.HIGHEST_PROTOCOL)


def _loads(b: bytes):
    return _wire(pickle.loads(b), False)


_WORKERS: List[_Worker] = []
_WORKERS_LOCK = threading.Lock()


def shutdown_workers():
    """Stop the mesh's worker processes (run at exit too)."""
    with _WORKERS_LOCK:
        for w in _WORKERS:
            w.close()
        _WORKERS.clear()


atexit.register(shutdown_workers)


def run_rows(mesh: Mesh, row_fn: Callable, row_args: Sequence[tuple]) -> List:
    """``row_fn(devices, *row_args[i])`` for every data row i of the mesh,
    ``devices`` the row's devices: in the calling process for a mesh of
    one row, else in worker process i each, all rows at once (the
    workers are spawned at first use and kept). ``row_fn`` must be a
    module's function and its arguments picklable; the results come back
    on the CPU. Raises the first row's error after every row has ended."""
    grid = mesh.grid()
    n = grid.shape[0]
    if n == 1:
        return [_row_call(row_fn, list(grid[0]), *row_args[0])]
    with _WORKERS_LOCK:
        for k, w in enumerate(_WORKERS):
            if not w.proc.is_alive():
                _WORKERS[k] = _Worker()
        while len(_WORKERS) < n:
            _WORKERS.append(_Worker())
        workers = _WORKERS[:n]
    try:  # every row's work pickled before any is sent
        payloads = [_dumps((_row_call, (row_fn, list(grid[i])) + tuple(row_args[i])))
                    for i in range(n)]
    except (pickle.PicklingError, AttributeError, TypeError) as e:
        raise TypeError(f"a mesh of several data rows sends its work to worker processes, "
                        f"and this work does not pickle: {e}") from e
    for w, payload in zip(workers, payloads):
        w.submit(payload)
    out, err = [], None
    for w in workers:
        try:
            out.append(w.result())
        except RuntimeError as e:
            err = err or e
            out.append(None)
    if err is not None:
        raise err
    return out


def _row_call(row_fn, devices, *args):
    """``row_fn(devices, *args)`` with the row's first device current."""
    with _on_device(devices[0]):
        return row_fn(devices, *args)


def _placed(fn, device, cams, split):
    """The measurement function for one shard: the caller's own when the
    shard holds every camera on the function's device, else
    ``fn.on(device, cams)``."""
    if not split and getattr(fn, "device", device) == device:
        return fn  # a bare closure is taken to be on its shard's device
    if not hasattr(fn, "on"):
        raise TypeError("a mesh over several devices or split cameras needs a measurement "
                        "function with on(device, cams), such as pipeline.ekf.RigFunction")
    return fn.on(device, cams)


def _solve_row(devices, parts, cams, cfg, key, fn, compute_cov, with_status):
    """One data row of ``sharded_fte_solver``: its shards' ``fte_solve``,
    one thread each, their camera sums across the row; returns the first
    shard's outputs (every shard of the row holds the same)."""
    from ..solvers.trajopt import fte_solve

    split = len(cams) > 1

    def work(j, camera_sum):
        dev = devices[j]
        x0, m, w_ = (t.to(dev) for t in parts[j])
        f = _placed(fn, dev, cams[j], split)
        kw = {key: f} if key != "hj_parts_fn" else {}
        X, info = fte_solve(f if key == "hj_parts_fn" else None, x0, m, w_, cfg,
                            compute_cov=compute_cov, device=dev, camera_sum=camera_sum, **kw)
        if not with_status:
            return (X,)
        out = (X, info["converged"], info["grad_norm"])
        return out + (info["marker_std"],) if compute_cov else out

    return run_shards(devices[:len(parts)], work)[0]


def sharded_fte_solver(mesh: Mesh, h_fn=None, cfg=None, shard_cameras: bool = True,
                       hj_parts_fn=None, with_status: bool = False,
                       compute_cov: bool = False, hj_fn=None):
    """A batched FTE solver over the mesh.

    The returned function maps (X0 (B, N, P), meas (B, N, C, L, 2),
    w (B, N, C, L)), or one ``ShardedBatch``, to X (B, N, P) on the
    mesh's first device, solved over 'data' (and over the cameras on
    'model' when ``shard_cameras``). With ``with_status`` it returns
    (X, converged (B,), grad_norm (B,)), and with ``compute_cov`` as well
    (..., marker_std (B, N, L, 3)), the Laplace posterior's error bars
    (hj_parts form only). The measurement form is ``hj_parts_fn`` when
    given, else ``hj_fn``, else ``h_fn`` (``fte_solve``'s three forms);
    over several devices or split cameras it must be a
    ``pipeline.ekf.RigFunction`` (``make_h_fn``, ``make_hj_fn``,
    ``make_hj_parts_fn`` and their generic twins), and over several data
    rows it must pickle (the cheetah's do; see ``run_rows``)."""
    if cfg is None:
        raise TypeError("sharded_fte_solver needs cfg")
    if hj_parts_fn is not None:
        key, fn = "hj_parts_fn", hj_parts_fn
    elif hj_fn is not None:
        key, fn = "hj_fn", hj_fn
    elif h_fn is not None:
        key, fn = "h_fn", h_fn
    else:
        raise ValueError("give h_fn, hj_fn or hj_parts_fn")
    if with_status and compute_cov and key != "hj_parts_fn":
        raise ValueError("marker_std needs hj_parts_fn")
    grid = mesh.grid()
    if shard_cameras and grid.shape[1] > 1:
        print(f"sharded_fte_solver: mesh {mesh.shape}, cameras over 'model', summed by "
              f"{TRANSPORT}", flush=True)

    def solve(X0, meas=None, w=None):
        if isinstance(X0, ShardedBatch):
            if X0.mesh is not mesh:
                raise ValueError("the batch was sharded over another mesh")
            parts, cams = X0.parts, X0.cams
        else:
            sb = _split(mesh, X0, meas, w, shard_cameras, place=grid.shape[0] == 1)
            parts, cams = sb.parts, sb.cams
        # a worker process gets the rig on the CPU and moves it itself
        f = fn.on(torch.device("cpu")) if len(parts) > 1 and hasattr(fn, "on") else fn
        rows = run_rows(mesh, _solve_row, [(parts[i], cams, cfg, key, f, compute_cov,
                                            with_status) for i in range(len(parts))])
        if len(rows) == 1:
            out = rows[0]
        else:
            dev = grid[0, 0]
            out = tuple(torch.cat([r[k].to(dev) for r in rows]) for k in range(len(rows[0])))
        return out if with_status else out[0]

    return solve

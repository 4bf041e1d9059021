"""A measurement piece for tests/test_torch_mesh.py that logs to a file
the cameras each call receives, with the process and thread that made
the call. It pickles, so it goes to the mesh's worker processes."""
import os
import threading

from acinoset_tpu_torch.pipeline import ekf


class CameraLogAux:
    def __init__(self, path):
        self.path = str(path)

    def __call__(self, pose, aux):
        with open(self.path, "a") as f:
            f.write(f"{os.getpid()} {threading.current_thread().name} {aux[0].shape[-3]}\n")
        return ekf.hj_parts_aux(pose, aux)


def read_log(path):
    """[(process, thread), cameras] per call."""
    with open(path) as f:
        return [((pid, thread), int(c)) for pid, thread, c in (ln.split() for ln in f)]

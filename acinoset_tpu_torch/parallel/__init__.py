"""Device meshes, the counterpart of acinoset_tpu.parallel."""
from . import mesh  # noqa: F401

"""See the package docstring of acinoset_tpu_torch."""

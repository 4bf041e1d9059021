"""Reconstruction quality metrics (the counterpart of acinoset_tpu.eval)."""

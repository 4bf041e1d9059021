"""The Mosaic probes (scripts/probe_mosaic.py, scripts/probe_mosaic2.py)
on the port's Hopper kernels: the plain PyTorch version of each probe
kernel and the probes' entry points."""

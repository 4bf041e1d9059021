"""Headless cores of the labelling and skeleton-authoring tools, the
counterpart of acinoset_tpu.gui."""
from . import label_session, skeleton_builder  # noqa: F401

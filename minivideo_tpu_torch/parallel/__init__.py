"""Batch decode on one device: the batch pipeline and its manifests.

Port of minivideo_tpu/parallel/ without its scale-out layer (the mesh
sharding, the halo engine and the multi-host launcher): clips run on one
device, and progress is checkpointed per clip.  Importing the package
loads no torch.
"""

from .manifest import Manifest
from .batch import BatchResult, batch_thumbnail

__all__ = ["Manifest", "batch_thumbnail", "BatchResult"]

"""Scale-out decode: mesh sharding, the batch pipeline, manifests.

Port of minivideo_tpu/parallel/: clips shard over the "data" mesh axis
and a clip's IDR pictures over "seq" (sharding.py), processes own
disjoint clip shards (batch.py, over torch.distributed's rank and world
size), and progress is checkpointed per clip (manifest.py).  halo.py
splits one frame's wavefront across mesh entries, and multihost.py runs
it all across worker processes.  Importing the package loads no torch.
"""

from .manifest import Manifest
from .sharding import make_mesh, pad_to_multiple, shard_packed
from .batch import BatchResult, batch_thumbnail

__all__ = ["Manifest", "make_mesh", "pad_to_multiple", "shard_packed",
           "batch_thumbnail", "BatchResult"]

"""Meshes and multi-host search — counterpart of the JAX package's
``parallel`` package.

- ``mesh``      — :func:`make_mesh`, a 1-D :class:`Mesh` of torch devices
  (a device may repeat: ``["cuda:0"] * 4`` is four shards on one card);
- ``resident``  — the file resident across a mesh, one word buffer per
  shard, every grid derived on its shard with its halo tile in place;
- ``sharded``   — the fused steps on every shard (kernels A and B, or C
  and B for keyword batches), each shard's work enqueued before any
  result is fetched;
- ``multihost`` — processes in a gloo group, each scanning its byte range,
  with the candidate lists all-gathered.

The engine takes a mesh from ``SearchConfig.devices`` and multi-host
search from ``SearchEngine.run_distributed``.
"""

from .mesh import DATA_AXIS, Mesh, make_mesh
from .multihost import (
    gather_results,
    host_byte_range,
    initialize_distributed,
    process_count,
    process_index,
)

__all__ = [
    "DATA_AXIS",
    "Mesh",
    "make_mesh",
    "gather_results",
    "host_byte_range",
    "initialize_distributed",
    "process_count",
    "process_index",
]

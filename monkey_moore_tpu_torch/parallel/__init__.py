"""Meshes and multi-host search — counterpart of the JAX package's
``parallel`` package.

- ``mesh``      — :func:`make_mesh`, a 1-D :class:`Mesh` of torch devices
  (a device may repeat: ``["cuda:0"] * 4`` is four shards on one card);
- ``resident``  — the file resident across a mesh, one word buffer per
  shard, every grid derived on its shard with its halo tile in place;
- ``sharded``   — the fused steps on every shard (kernels A and L, or C
  and L for keyword batches), each shard's work enqueued before any
  result is fetched, and the exact match-and-compact scan
  (:func:`sharded_candidates`, :func:`sharded_scan_fn`: kernel K per
  shard with an ``L - 1`` halo);
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
from .sharded import sharded_candidates, sharded_scan_fn

__all__ = [
    "DATA_AXIS",
    "Mesh",
    "make_mesh",
    "sharded_candidates",
    "sharded_scan_fn",
    "gather_results",
    "host_byte_range",
    "initialize_distributed",
    "process_count",
    "process_index",
]

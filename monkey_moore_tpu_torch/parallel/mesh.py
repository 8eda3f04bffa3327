"""Device mesh — counterpart of the JAX package's ``parallel/mesh.py``.

The reference's only parallelism is data-parallel file blocks on a CPU
thread pool (``src/core/search_engine.cpp:67-175``).  The JAX package maps
the corpus onto a 1-D ``jax.sharding.Mesh``; the port's :class:`Mesh` is
the same idea without a collective runtime: an ordered tuple of
``torch.device``, one entry per shard.  Every shard owns its buffers and
its launches, and the halo between neighbours is a ``copy_`` from one
shard's device to the other's (``sharded.py``).

A device may appear more than once: ``["cuda:0"] * 4`` is a four-shard
mesh on one card (the shard and halo arithmetic, the per-shard launches),
``["cpu"] * n`` the same on the kernels' plain versions.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch

from ..dense import resolve_device

__all__ = ["DATA_AXIS", "Mesh", "make_mesh"]

#: the name of the mesh's one axis (the sequence dimension of the corpus)
DATA_AXIS = "data"


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: one ``torch.device`` per shard, in corpus order."""

    devices: Tuple[torch.device, ...]

    def __len__(self) -> int:
        return len(self.devices)

    def key(self) -> Tuple[str, ...]:
        """The mesh as strings, for cache keys."""
        return tuple(str(d) for d in self.devices)


def _as_device(entry) -> torch.device:
    """One mesh entry as a ``torch.device``: a ``torch.device``, a string
    (``"cuda:0"``, ``"cpu"``) or a card index; anything else (a JAX
    ``Device`` among them) raises ``TypeError``."""
    if isinstance(entry, bool) or not isinstance(
        entry, (torch.device, str, int)
    ):
        kind = type(entry)
        raise TypeError(
            "make_mesh: a mesh entry must be a torch.device, str or int, not "
            f"{kind.__module__}.{kind.__qualname__}"
        )
    if isinstance(entry, int):
        entry = torch.device("cuda", entry)
    return resolve_device(entry, "make_mesh")


def make_mesh(devices: Optional[Sequence] = None,
              n: Optional[int] = None) -> Mesh:
    """1-D mesh over *devices* (default: every card, never the CPU;
    raises without one), optionally the first *n*."""
    if devices is None:
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError("make_mesh: CUDA is not available")
        devices = [torch.device("cuda", i) for i in range(count)]
    if isinstance(devices, (str, torch.device)):
        raise TypeError("make_mesh: devices must be a sequence of devices")
    devices = list(devices)
    if n is not None:
        devices = devices[:n]
    if not devices:
        raise ValueError("make_mesh: a mesh needs at least one device")
    return Mesh(tuple(_as_device(d) for d in devices))

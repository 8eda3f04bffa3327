"""Multi-host search — counterpart of the JAX package's
``parallel/multihost.py``.

Design (the reference's overlapping block reads rather than halos sent
between hosts, ``src/core/search_engine.cpp:120-127``):

- each process scans the window starts inside its own byte range of the
  file (:func:`host_byte_range`: a ceil split, each range reading
  ``pattern_len*element_size - 1`` halo bytes past its end), on its own
  device or mesh;
- the per-process candidate lists are all-gathered (:func:`gather_results`)
  and merged by offset, so every process returns the same global list.

The processes form a ``torch.distributed`` group on the **gloo** backend,
on the card too.  What crosses between processes is a host array of
candidates (the JAX gather moves numpy arrays as well), so a CPU
collective is the natural carrier; and NCCL refuses two ranks on one card,
which is how a one-card host runs two processes.  Nothing tells a program
of a cluster, so :func:`initialize_distributed` takes the coordinator's
address, the world size and the rank.

A single process degrades gracefully: its range is the whole file and the
gather is the identity.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

__all__ = [
    "initialize_distributed",
    "host_byte_range",
    "gather_results",
    "process_count",
    "process_index",
]


def _initialized() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Join the gloo process group at ``tcp://coordinator_address``
    (``host:port``; rank 0 listens there) as rank *process_id* of
    *num_processes*.  With neither an address nor a count it does nothing
    (a single process)."""
    if coordinator_address is None and num_processes is None:
        return
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError(
            "initialize_distributed: give the coordinator address, the "
            "number of processes and this process's id"
        )
    import torch.distributed as dist

    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
    )


def process_count() -> int:
    """Processes in the group (1 before :func:`initialize_distributed`)."""
    if not _initialized():
        return 1
    import torch.distributed as dist

    return dist.get_world_size()


def process_index() -> int:
    """This process's rank (0 before :func:`initialize_distributed`)."""
    if not _initialized():
        return 0
    import torch.distributed as dist

    return dist.get_rank()


def host_byte_range(
    file_size: int,
    pattern_len: int,
    element_size: int,
    index: Optional[int] = None,
    count: Optional[int] = None,
) -> Tuple[int, int]:
    """This host's (start, stop) byte range including trailing halo.

    Ranges advance by ``ceil(file_size / hosts)`` and read
    ``pattern_len*element_size - 1`` extra bytes so matches straddling host
    boundaries are found by exactly one host — the host whose base region
    contains the match start.  (Note: this halo is ``element_size - 1`` bytes
    *longer* than the reference's block halo, ``search_engine.cpp:227``, which
    is one element short for odd-aligned 16-bit matches near a block end and
    silently misses them; host ranges are a new layer with no reference
    behavior to mirror, so they are lossless.)
    """
    if count is None:
        count = process_count()
    if index is None:
        index = process_index()
    base = -(-file_size // count)
    halo = pattern_len * element_size - 1
    start = min(index * base, file_size)
    stop = min(start + base + halo, file_size)
    return start, stop


def gather_results(offsets: np.ndarray, values: np.ndarray):
    """All-gather per-host candidate lists across processes and merge-sort
    by offset.  Uses fixed-size padding (max count across hosts, offsets
    -1) as the JAX gather does, through ``dist.all_gather`` of CPU int64
    tensors."""
    if process_count() == 1:
        return offsets, values
    import torch
    import torch.distributed as dist

    n_proc = dist.get_world_size()
    local_n = torch.tensor([len(offsets)], dtype=torch.int64)
    counts = [torch.zeros(1, dtype=torch.int64) for _ in range(n_proc)]
    dist.all_gather(counts, local_n)
    # at least one slot: gloo gathers no empty tensors
    cap = max(1, max(int(c) for c in counts))
    pad_offs = np.full(cap, -1, dtype=np.int64)
    pad_offs[: len(offsets)] = offsets
    pad_vals = np.zeros((cap, 2), dtype=np.int64)
    pad_vals[: len(values)] = values
    all_offs = [torch.empty(cap, dtype=torch.int64) for _ in range(n_proc)]
    all_vals = [torch.empty((cap, 2), dtype=torch.int64)
                for _ in range(n_proc)]
    dist.all_gather(all_offs, torch.from_numpy(pad_offs))
    dist.all_gather(all_vals, torch.from_numpy(pad_vals))
    offs = torch.cat(all_offs).numpy()
    vals = torch.cat(all_vals).numpy().reshape(-1, 2)
    keep = offs >= 0
    offs, vals = offs[keep], vals[keep]
    order = np.argsort(offs, kind="stable")
    return offs[order], vals[order]

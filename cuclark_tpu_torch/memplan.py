"""Device-memory planning for the DB table.

Counterpart of `cuclark_tpu/memplan.py`.  The reference probes each
device's free VRAM, reserves RESERVED MB for batch buffers, and derives
its swap-cycle plan from what remains (src/CuClarkDB.cu:540-574,
src/parameters.hh:45).  Here the free memory of a CUDA device comes
from `torch.cuda.mem_get_info`, a reserve for the batches in flight
comes off it, and the result feeds the two levers of the JAX package:

  - stream_parts: host-to-device bucket-range streaming (the swap-cycle
    analog) when the table exceeds the budget, and
  - the db-axis width of a mesh (plan_db_axis, kept for the mesh port).

An explicit --max-table-mb always wins; this module only fills in the
default so an oversized table streams instead of dying mid-classify
with an out-of-memory error.  The JAX package's table of TPU
generations has no counterpart: a CUDA device always reports its free
memory.
"""

from __future__ import annotations

import os

import torch

# Reserve for batch buffers, results and scratch, the role of the
# reference's RESERVED = 300-400 MB per device (src/parameters.hh:45).
RESERVED_MB = 512.0


def device_memory_budget_mb(device) -> float | None:
    """Usable MB for the resident DB table on `device` (a torch device
    or its name): its free memory less RESERVED_MB, at least 64 MB.
    None for the CPU (host memory, no practical table limit).  The
    CUCLARK_DEVICE_MB environment variable overrides the measurement on
    every device."""
    override = os.environ.get("CUCLARK_DEVICE_MB")
    if override:  # operator override / test hook
        return float(override)
    device = torch.device(device)
    if device.type != "cuda":
        return None
    free, _ = torch.cuda.mem_get_info(device)
    return max(free / 1e6 - RESERVED_MB, 64.0)


def resolve_table_budget_mb(max_table_mb: float | None,
                            device) -> float | None:
    """Effective per-device table budget: the explicit flag if given,
    else the measured device budget (None = unbounded)."""
    if max_table_mb is not None:
        return max_table_mb
    return device_memory_budget_mb(device)


def plan_stream_parts(table_bytes: int, budget_mb: float | None,
                      num_db: int, nb: int) -> int:
    """Power-of-two host-streaming parts needed so each uploaded
    bucket-range part (already split num_db ways across a mesh) fits
    the per-device budget.  1 = fully resident."""
    parts = 1
    if budget_mb is None:
        return parts
    budget = budget_mb * 1e6
    while (table_bytes / num_db / parts > budget
           and parts * num_db < nb):
        parts *= 2
    return parts


def plan_db_axis(table_bytes: int, budget_mb: float | None,
                 max_devices: int) -> int:
    """Power-of-two db-axis width so each device's resident shard fits
    the budget (capped at the device count; streaming picks up the
    remainder)."""
    num_db = 1
    if budget_mb is None:
        return num_db
    budget = budget_mb * 1e6
    while table_bytes / num_db > budget and num_db * 2 <= max_devices:
        num_db *= 2
    return num_db

"""Multi-device and multi-process classify: `mesh` (a data x db grid of
torch devices in one process) and `multihost` (per-host input sharding
and the multi-process engine over torch.distributed)."""

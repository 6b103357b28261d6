"""Stable partition of ray or sample slots by a mask.

Port of nerf_glasses_tpu/ops/compaction.py::stable_partition_ids without
its TPU block-matmul prefix sum: `nonzero` lists the True ids in order.
"""

from __future__ import annotations

import torch


def stable_partition_perm(mask: torch.Tensor) -> torch.Tensor:
    """stable_partition_ids' permutation without its count, and without
    a host read: a stable sort of the mask's complement."""
    return torch.argsort((~mask).to(torch.uint8), stable=True)


def stable_partition_ids(mask: torch.Tensor):
    """mask (N,) bool -> (perm (N,) int64, n_true int): the True ids
    ascending, then the False ids ascending."""
    true_ids = torch.nonzero(mask).squeeze(1)
    false_ids = torch.nonzero(~mask).squeeze(1)
    return torch.cat([true_ids, false_ids]), true_ids.numel()

"""FullyFusedMLP-equivalent multi-layer perceptron.

Port of nerf_glasses_tpu/ops/mlp.py: no biases, each layer
y = act(x @ W.T) with W (n_out, n_in). The reference multiplies
`compute_dtype` operands with f32 accumulation and an f32 result, and
casts hidden activations back to `compute_dtype` after the ReLU.
`torch.matmul` on bf16 would round its result to bf16, so here the
operands are rounded to `compute_dtype` and multiplied in f32 (TF32 is
off package-wide): the same rounding points, an exact product of the
rounded operands and an f32 sum.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch


def mlp_apply(x: torch.Tensor, weights: Sequence[torch.Tensor],
              compute_dtype=torch.bfloat16) -> torch.Tensor:
    """x (N, n_in) -> (N, n_out_padded) f32; ReLU after every layer but
    the last (output_activation=None in all reference configs)."""
    h = x.to(compute_dtype).float()
    for w in weights[:-1]:
        h = torch.relu(h @ w.to(compute_dtype).float().T)
        h = h.to(compute_dtype).float()
    return h @ weights[-1].to(compute_dtype).float().T


def mlp_init(generator: torch.Generator, shapes, device="cpu"):
    """Xavier-uniform weights, U(-s, s) with s = sqrt(6 / (n_in + n_out))
    per (n_out, n_in) matrix (the JAX package's mlp_init, tcnn's default
    initialisation), drawn from `generator` on `device`."""
    ws = []
    for n_out, n_in in shapes:
        s = math.sqrt(6.0 / (n_in + n_out))
        u = torch.rand((n_out, n_in), generator=generator, device=device)
        ws.append(u * (2.0 * s) - s)
    return ws

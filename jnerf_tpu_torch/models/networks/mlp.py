"""Bias-free MLP blocks, weights stored ``w[in, out]`` as in the JAX package.

Counterpart of `jnerf_tpu/models/networks/mlp.py` for the bias-free NGP
networks.  The precision policy is the JAX package's: with a bf16 compute
dtype both operands of each product are rounded to bf16, the product is
accumulated and returned in f32 (JAX's ``preferred_element_type=f32``),
ReLU runs in f32 and hidden activations are re-cast to bf16; the final
layer's output stays f32.

A plain ``torch.matmul`` of bf16 tensors would return bf16 and round once
more than JAX does, so the product here is an f32 matmul of the
bf16-rounded operands.  Products of two bf16 values are exact in f32 (and
in TF32, whose 10-bit mantissa holds bf16's 7), so the card's f32/TF32
matmul and the CPU's give the JAX result up to summation order.  The
backward of each ``.to(bf16)`` rounds the gradient to bf16 exactly where
JAX's transposed dot does.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn


def init_linear_(w: torch.Tensor, generator: torch.Generator) -> None:
    """He/Kaiming-uniform init in place: U(-sqrt(6/in), sqrt(6/in))."""
    bound = math.sqrt(6.0 / w.shape[0])
    with torch.no_grad():
        w.copy_(torch.rand(w.shape, generator=generator, device=w.device)
                * (2 * bound) - bound)


def apply_linear(w: torch.Tensor, x: torch.Tensor, compute_dtype=None):
    """x [N, in] @ w [in, out] -> [N, out] f32."""
    if compute_dtype is not None:
        w = w.to(compute_dtype)
        x = x.to(compute_dtype)
    return torch.matmul(x.float(), w.float())


def apply_mlp(weights: Sequence[torch.Tensor], x: torch.Tensor,
              compute_dtype=None):
    """ReLU-hidden MLP; the final layer is linear and returns f32."""
    n = len(weights)
    for i, w in enumerate(weights):
        x = apply_linear(w, x, compute_dtype)
        if i < n - 1:
            x = torch.relu(x)
            if compute_dtype is not None:
                x = x.to(compute_dtype)
    return x


class MLP(nn.Module):
    """Bias-free MLP of ``dims = [in, h1, ..., out]``."""

    def __init__(self, dims: Sequence[int]):
        super().__init__()
        self.dims = list(dims)
        self.weights = nn.ParameterList([
            nn.Parameter(torch.empty((dims[i], dims[i + 1])))
            for i in range(len(dims) - 1)
        ])

    def reset_parameters(self, generator: torch.Generator):
        for w in self.weights:
            init_linear_(w, generator)

    def forward(self, x, compute_dtype=None):
        return apply_mlp(list(self.weights), x, compute_dtype)

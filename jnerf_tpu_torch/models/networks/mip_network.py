"""Mip-NeRF MLP: one network shared by the coarse and fine levels.

Counterpart of `jnerf_tpu/models/networks/mip_network.py`: an 8 x 256
trunk over the integrated positional encoding, the encoding concatenated
back in after each layer ``i`` with ``i % skip_layer == 0, i > 0``, a
density head, and, with ``use_viewdirs``, a bottleneck whose output meets
the encoded view direction in a 1 x 128 colour branch.  Config keys are
``mip_base.py``'s.  Every layer is ``{w, b}`` in f32 and every product
runs in f32, as in the JAX package (``apply_linear`` without a compute
dtype): these operands are not bf16-rounded, so TF32 would change the
result, and the card must keep PyTorch's default
``torch.backends.cuda.matmul.allow_tf32 = False``.  The parameter names
(``trunk.<i>``, ``density``, ``bottleneck``, ``condition.<i>``, ``rgb``)
are the JAX tree's keys (`utils/convert.py`).
"""

from __future__ import annotations

import torch
from torch import nn

from jnerf_tpu_torch.utils.config import get_cfg
from jnerf_tpu_torch.utils.registry import NETWORKS
from .mlp import Linear


@NETWORKS.register_module()
class MipNerfMLP(nn.Module):
    def __init__(self, device=None, generator: torch.Generator | None = None):
        super().__init__()
        cfg = get_cfg()
        self.net_depth = cfg.net_depth or 8
        self.net_width = cfg.net_width or 256
        self.skip_layer = cfg.skip_layer or 4
        self.net_depth_condition = cfg.net_depth_condition or 1
        self.net_width_condition = cfg.net_width_condition or 128
        self.num_density_channels = cfg.num_density_channels or 1
        self.num_rgb_channels = cfg.num_rgb_channels or 3
        self.use_viewdirs = bool(cfg.use_viewdirs)
        # IPE over degrees [min_deg_point, max_deg_point): 2 (sin, cos) x 3.
        self.in_dim = 2 * 3 * (cfg.max_deg_point - cfg.min_deg_point)
        # The view direction's pos_enc with the identity appended.
        self.view_dim = 3 + 2 * 3 * cfg.deg_view

        trunk, in_dim = [], self.in_dim
        for i in range(self.net_depth):
            trunk.append(Linear(in_dim, self.net_width))
            in_dim = self.net_width
            if self._skip(i):
                in_dim = self.net_width + self.in_dim
        self.trunk = nn.ModuleList(trunk)
        self.density = Linear(self.net_width, self.num_density_channels)
        self.bottleneck = Linear(self.net_width, self.net_width)
        cond, in_dim = [], self.net_width + self.view_dim
        for _ in range(self.net_depth_condition):
            cond.append(Linear(in_dim, self.net_width_condition))
            in_dim = self.net_width_condition
        self.condition = nn.ModuleList(cond)
        self.rgb = Linear(in_dim, self.num_rgb_channels)
        if device is not None:
            self.to(device)
        if generator is not None:
            self.reset_parameters(generator)

    def _skip(self, i: int) -> bool:
        return i % self.skip_layer == 0 and i > 0

    def reset_parameters(self, generator: torch.Generator):
        """Draw every parameter from ``generator`` (on its device)."""
        for layer in (*self.trunk, self.density, self.bottleneck,
                      *self.condition, self.rgb):
            layer.reset_parameters(generator)

    def forward(self, samples_enc, viewdirs_enc):
        """samples_enc [R, S, F], viewdirs_enc [R, Fv] -> (raw_rgb [R, S,
        3], raw_density [R, S, 1])."""
        r, s, _ = samples_enc.shape
        x = samples_enc.reshape(r * s, -1)
        inputs = x
        for i, layer in enumerate(self.trunk):
            x = torch.relu(layer(x))
            if self._skip(i):
                x = torch.cat([x, inputs], dim=-1)
        raw_density = self.density(x).reshape(r, s, self.num_density_channels)
        if self.use_viewdirs:
            bottleneck = self.bottleneck(x)
            cond = torch.repeat_interleave(viewdirs_enc, s, dim=0)
            x = torch.cat([bottleneck, cond], dim=-1)
            for layer in self.condition:
                x = torch.relu(layer(x))
        raw_rgb = self.rgb(x).reshape(r, s, self.num_rgb_channels)
        return raw_rgb, raw_density

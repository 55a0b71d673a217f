"""Vanilla NeRF MLP (8x256, skip at 4, 128-wide view branch).

Counterpart of `jnerf_tpu/models/networks/ori_nerf_network.py`, with the
reference's skip quirk: the skip concat ``[pos_feat, h]`` comes *after*
layer 4's ReLU, so it feeds layer 5.  Each layer is ``{w, b}``; with
``cfg.fp16`` the products take bf16 operands (f32 accumulation, bias added
in f32), otherwise f32.  Output ``[rgb_raw, sigma_raw]``; ``density()``
serves the occupancy-grid refresh.
"""

from __future__ import annotations

import torch
from torch import nn

from jnerf_tpu_torch.utils.config import get_cfg
from jnerf_tpu_torch.utils.registry import ENCODERS, NETWORKS, build_from_cfg
from .mlp import Linear


@NETWORKS.register_module()
class OriginNeRFNetworks(nn.Module):
    def __init__(self, D=8, W=256, skips=(4,), device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        cfg = get_cfg()
        self.compute_dtype = torch.bfloat16 if cfg.fp16 else None
        self.D, self.W, self.skips = D, W, tuple(skips)
        self.pos_encoder = build_from_cfg(cfg.encoder.pos_encoder, ENCODERS)
        self.dir_encoder = build_from_cfg(cfg.encoder.dir_encoder, ENCODERS)
        in_dim = self.pos_encoder.out_dim
        dims = [(in_dim, W)] + [(W + in_dim, W) if i in self.skips else (W, W)
                                for i in range(D - 1)]
        self.pts_linears = nn.ModuleList([Linear(i, o) for i, o in dims])
        self.feature_linear = Linear(W, W)
        self.alpha_linear = Linear(W, 1)
        self.views_linear = Linear(self.dir_encoder.out_dim + W, W // 2)
        self.rgb_linear = Linear(W // 2, 3)
        if device is not None:
            self.to(device)
        if generator is not None:
            self.reset_parameters(generator)

    def reset_parameters(self, generator: torch.Generator):
        """Draw every parameter from ``generator`` (on its device)."""
        for layer in (*self.pts_linears, self.feature_linear,
                      self.alpha_linear, self.views_linear, self.rgb_linear):
            layer.reset_parameters(generator)

    def _trunk(self, pos_feat):
        h = pos_feat
        for i, layer in enumerate(self.pts_linears):
            h = torch.relu(layer(h, self.compute_dtype))
            if i in self.skips:
                h = torch.cat([pos_feat, h], dim=-1)
        return h

    def forward(self, pos, dirs):
        """[N, 3] warped pos, [N, 3] dirs -> [N, 4] raw (rgb, sigma) f32."""
        dir_feat = self.dir_encoder(dirs)
        h = self._trunk(self.pos_encoder(pos))
        alpha = self.alpha_linear(h, self.compute_dtype)
        feature = self.feature_linear(h, self.compute_dtype)
        h = torch.relu(self.views_linear(torch.cat([feature, dir_feat], dim=-1),
                                         self.compute_dtype))
        rgb = self.rgb_linear(h, self.compute_dtype)
        return torch.cat([rgb, alpha], dim=-1)

    def density(self, pos):
        """[N, 3] warped pos -> [N, 1] raw sigma (pre-activation)."""
        return self.alpha_linear(self._trunk(self.pos_encoder(pos)),
                                 self.compute_dtype)

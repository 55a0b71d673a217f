"""Instant-NGP network: hash encode -> density MLP; SH + density feature -> RGB MLP.

Counterpart of `jnerf_tpu/models/networks/ngp_network.py` (density MLP
32->64->16, rgb MLP 32->64->64->3, both bias-free; output
``[rgb_raw, sigma_raw]``; ``density()`` serves the occupancy-grid sweep).
The JAX package's opt-in fused-MLP Pallas kernel (``cfg.use_pallas_mlp``)
is not ported yet, so that option raises here instead of silently running
the plain chain.
"""

from __future__ import annotations

import torch
from torch import nn

from jnerf_tpu_torch.utils.config import get_cfg
from jnerf_tpu_torch.utils.registry import ENCODERS, NETWORKS, build_from_cfg
from .mlp import MLP


@NETWORKS.register_module()
class NGPNetworks(nn.Module):
    def __init__(
        self,
        use_fully=True,
        density_hidden_layer=1,
        density_n_neurons=64,
        rgb_hidden_layer=2,
        rgb_n_neurons=64,
        device=None,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        cfg = get_cfg()
        if cfg.use_pallas_mlp:
            raise NotImplementedError(
                "cfg.use_pallas_mlp: the fused NGP MLP kernels are not ported "
                "yet (ROADMAP.md, port queue: fused MLP kernels #4-#6)")
        # cfg.fp16 selects reduced precision; as in the JAX package that
        # means bf16, and configs that omit the key get it too.
        self.compute_dtype = (torch.bfloat16 if cfg.fp16 in (None, True)
                              else torch.float32)
        self.use_fully = use_fully
        self.pos_encoder = build_from_cfg(cfg.encoder.pos_encoder, ENCODERS)
        self.dir_encoder = build_from_cfg(cfg.encoder.dir_encoder, ENCODERS)
        self.pos_encoder.compute_dtype = self.compute_dtype
        self.dir_encoder.compute_dtype = self.compute_dtype
        self.density_mlp = MLP([self.pos_encoder.out_dim]
                               + [density_n_neurons] * density_hidden_layer
                               + [16])
        self.rgb_mlp = MLP([self.dir_encoder.out_dim + 16]
                           + [rgb_n_neurons] * rgb_hidden_layer + [3])
        if device is not None:
            self.to(device)
        if generator is not None:
            self.reset_parameters(generator)

    def reset_parameters(self, generator: torch.Generator):
        """Draw every parameter from ``generator`` (on its device)."""
        self.pos_encoder.reset_parameters(generator)
        self.dir_encoder.reset_parameters(generator)
        self.density_mlp.reset_parameters(generator)
        self.rgb_mlp.reset_parameters(generator)

    def forward(self, pos, dirs):
        """[N,3] warped pos, [N,3] warped dirs -> [N,4] raw (rgb, sigma) f32."""
        dir_feat = self.dir_encoder(dirs)
        pos_feat = self.pos_encoder(pos)
        density = self.density_mlp(pos_feat, self.compute_dtype)
        h = torch.cat([density.to(self.compute_dtype),
                       dir_feat.to(self.compute_dtype)], dim=-1)
        rgb = self.rgb_mlp(h, self.compute_dtype)
        return torch.cat([rgb, density[..., :1]], dim=-1).float()

    def density(self, pos):
        """[N,3] warped pos -> [N,1] raw sigma (pre-activation)."""
        feat = self.pos_encoder(pos)
        out = self.density_mlp(feat, self.compute_dtype)
        return out[:, :1].float()

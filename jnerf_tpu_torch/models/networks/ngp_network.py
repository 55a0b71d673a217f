"""Instant-NGP network: hash encode -> density MLP; SH + density feature -> RGB MLP.

Counterpart of `jnerf_tpu/models/networks/ngp_network.py` (density MLP
32->64->16, rgb MLP 32->64->64->3, both bias-free; output
``[rgb_raw, sigma_raw]``; ``density()`` serves the occupancy-grid sweep).
With ``cfg.use_pallas_mlp`` on a fused-shape bf16 network, the forward
takes `ops.fused_mlp.fused_ngp_mlp` (F-MLP forward, B-MLP backward on the
card) whenever the row count is a multiple of its ``_BLK``, exactly where
the JAX package takes its Pallas kernel; other row counts run the plain
chain.  The two differ in the backward's quantization, so the gate
decides which function is computed.  ``density()`` stays on the plain
chain, as in the JAX package.
"""

from __future__ import annotations

import torch
from torch import nn

from jnerf_tpu_torch.ops import fused_mlp as _fm
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
        self._fused_ok = bool(
            cfg.use_pallas_mlp
            and use_fully
            and self.compute_dtype == torch.bfloat16
            and self.density_mlp.dims == [_fm.D_IN, _fm.D_HID, _fm.D_GEO]
            and self.rgb_mlp.dims == [_fm.RGB_IN, _fm.D_HID, _fm.D_HID, 3]
            and self.dir_encoder.out_dim == _fm.SH_DIM
        )
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
        if self._fused_ok and pos.shape[0] % _fm._BLK == 0:
            return _fm.fused_ngp_mlp(self._mlp_weights(), pos_feat, dir_feat)
        density = self.density_mlp(pos_feat, self.compute_dtype)
        h = torch.cat([density.to(self.compute_dtype),
                       dir_feat.to(self.compute_dtype)], dim=-1)
        rgb = self.rgb_mlp(h, self.compute_dtype)
        return torch.cat([rgb, density[..., :1]], dim=-1).float()

    def _mlp_weights(self):
        return tuple(self.density_mlp.weights) + tuple(self.rgb_mlp.weights)

    def density(self, pos):
        """[N,3] warped pos -> [N,1] raw sigma (pre-activation)."""
        feat = self.pos_encoder(pos)
        out = self.density_mlp(feat, self.compute_dtype)
        return out[:, :1].float()

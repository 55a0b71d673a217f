"""NeuS networks: the SDF MLP (geometric init), the IDR-style colour MLP,
the NeRF++ background and the learned variance.

Counterpart of `jnerf_tpu/models/networks/neus_network.py`.  Every layer is
``{w, b}`` in f32 and every product runs in f32 (the JAX package calls
``apply_linear`` without a compute dtype), so the f32 matmuls must not be
demoted to TF32 on the card: PyTorch's default
(``torch.backends.cuda.matmul.allow_tf32 = False``) keeps them f32.
``weight_norm=True`` is accepted and, as in the JAX package, adds no
weight-norm parameters (ROADMAP.md §3).  The SDF's spatial gradient comes
from ``torch.autograd.grad(..., create_graph=True)`` so that the eikonal
term differentiates it again.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from jnerf_tpu_torch.utils.config import get_cfg
from jnerf_tpu_torch.utils.registry import ENCODERS, NETWORKS, build_from_cfg
from .mlp import Linear, init_linear_


class _Softplus(torch.autograd.Function):
    """softplus(z) = max(z, 0) + log1p(exp(-|z|)) with JAX's derivative
    exp(z - softplus(z)) (``jnp.logaddexp(z, 0)``'s): finite for any f32 z
    at every order, where ``1 / (1 + exp(-z))`` overflows to inf/inf in the
    eikonal term's second derivative."""

    @staticmethod
    def forward(ctx, z):
        out = torch.clamp(z, min=0) + torch.log1p(torch.exp(-torch.abs(z)))
        ctx.save_for_backward(z, out)
        return out

    @staticmethod
    def backward(ctx, g):
        z, out = ctx.saved_tensors
        return g * torch.exp(z - out)


def softplus(z):
    """``jax.nn.softplus``: log(1 + exp(z)), with JAX's derivative."""
    return _Softplus.apply(z)


def softplus100(h):
    """Softplus with beta = 100: softplus(100 h) / 100 (`neus_network.py:75`)."""
    return softplus(100.0 * h) / 100.0


def _zero_bias_(layer: Linear, generator: torch.Generator):
    """w ~ U(+-sqrt(6/in)), b = 0: the JAX NeuS networks' plain init."""
    init_linear_(layer.w, generator)
    with torch.no_grad():
        layer.b.zero_()


def _normal(shape, mean, std, generator, device):
    return mean + std * torch.randn(shape, generator=generator, device=device)


class SDFNetwork(nn.Module):
    """Softplus(beta=100) MLP with a skip at layer 4 and geometric init.

    Output [N, 1 + d_feature] = (sdf, geometry features); the geometric
    init makes the field approximately |x| - ``bias``.
    """

    def __init__(self, d_out, d_hidden, n_layers, skip_in=(4,), bias=0.5,
                 scale=1.0, geometric_init=True, weight_norm=True,
                 inside_outside=False):
        super().__init__()
        del weight_norm  # no weight-norm parameters, as in the JAX package
        cfg = get_cfg()
        self.encoder = build_from_cfg(cfg.encoder.sdf_encoder, ENCODERS)
        self.d_in_raw = cfg.encoder.sdf_encoder.input_dims or 3
        dims = [self.encoder.out_dim] + [d_hidden] * n_layers + [d_out]
        self.dims = dims
        self.skip_in = tuple(skip_in)
        self.scale = scale
        self.bias = bias
        self.geometric_init = geometric_init
        self.inside_outside = inside_outside
        self.n_layers = len(dims) - 1
        self.layers = nn.ModuleList([
            Linear(dims[l], dims[l + 1] - dims[0] if l + 1 in self.skip_in
                   else dims[l + 1])
            for l in range(self.n_layers)])

    def reset_parameters(self, generator: torch.Generator):
        """The geometric init (`neus_network.py:50-68`) from ``generator``."""
        d0 = self.dims[0]
        for l, layer in enumerate(self.layers):
            in_dim, out_dim = layer.w.shape
            dev = layer.w.device
            std = math.sqrt(2) / math.sqrt(out_dim)
            if not self.geometric_init:
                _zero_bias_(layer, generator)
                continue
            if l == self.n_layers - 1:
                mean = math.sqrt(math.pi) / math.sqrt(in_dim)
                sign = -1.0 if self.inside_outside else 1.0
                w = _normal((in_dim, out_dim), sign * mean, 1e-4, generator,
                            dev)
                b = torch.full((out_dim,), -sign * self.bias, device=dev)
            elif l == 0:
                # Only the raw xyz slice of the input gets signal.
                w = torch.zeros((in_dim, out_dim), device=dev)
                w[:self.d_in_raw] = _normal((self.d_in_raw, out_dim), 0.0, std,
                                            generator, dev)
                b = torch.zeros((out_dim,), device=dev)
            else:
                w = _normal((in_dim, out_dim), 0.0, std, generator, dev)
                if l in self.skip_in:
                    # The encoded-frequency tail of the skip input starts at 0.
                    w[in_dim - (d0 - self.d_in_raw):] = 0.0
                b = torch.zeros((out_dim,), device=dev)
            with torch.no_grad():
                layer.w.copy_(w)
                layer.b.copy_(b)

    def forward(self, x):
        """[N, 3] -> [N, d_out]; column 0 is the sdf."""
        inputs = self.encoder(x * self.scale)
        h = inputs
        for l, layer in enumerate(self.layers):
            if l in self.skip_in:
                h = torch.cat([h, inputs], dim=-1) / math.sqrt(2)
            h = layer(h)
            if l < self.n_layers - 1:
                h = softplus100(h)
        return torch.cat([h[:, :1] / self.scale, h[:, 1:]], dim=-1)

    def sdf(self, x):
        return self(x)[:, :1]

    def sdf_and_gradient(self, x):
        """(forward [N, d_out], d sdf / dx [N, 3]) from one forward pass.
        The gradient keeps its graph (for the eikonal term's second
        derivative) when grad mode is on at the call."""
        create_graph = torch.is_grad_enabled()
        with torch.enable_grad():
            x = x.detach().requires_grad_(True)
            out = self(x)
            g, = torch.autograd.grad(out[:, :1], x, torch.ones_like(out[:, :1]),
                                     create_graph=create_graph)
        return out, g

    def gradient(self, x):
        """[N, 3] -> [N, 3] spatial gradient of the sdf."""
        return self.sdf_and_gradient(x)[1]


class RenderingNetwork(nn.Module):
    """IDR-style colour MLP over (points, view dirs, normals, features)."""

    def __init__(self, d_feature, mode, d_out, d_hidden, n_layers,
                 weight_norm=True, squeeze_out=True):
        super().__init__()
        del weight_norm
        cfg = get_cfg()
        self.mode = mode
        self.squeeze_out = squeeze_out
        d_in = 9  # points + view dirs + normals
        self.encoder = None
        if cfg.encoder.rendering_encoder.multires > 0:
            self.encoder = build_from_cfg(cfg.encoder.rendering_encoder,
                                          ENCODERS)
            d_in += self.encoder.out_dim - 3
        if mode == "no_view_dir":
            d_in -= self.encoder.out_dim if self.encoder else 3
        elif mode == "no_normal":
            d_in -= 3
        self.dims = [d_in + d_feature] + [d_hidden] * n_layers + [d_out]
        self.layers = nn.ModuleList([
            Linear(self.dims[l], self.dims[l + 1])
            for l in range(len(self.dims) - 1)])

    def reset_parameters(self, generator: torch.Generator):
        for layer in self.layers:
            _zero_bias_(layer, generator)

    def forward(self, points, normals, view_dirs, feature_vectors):
        if self.encoder is not None and self.mode != "no_view_dir":
            view_dirs = self.encoder(view_dirs)
        if self.mode == "idr":
            h = torch.cat([points, view_dirs, normals, feature_vectors], -1)
        elif self.mode == "no_view_dir":
            h = torch.cat([points, normals, feature_vectors], -1)
        elif self.mode == "no_normal":
            h = torch.cat([points, view_dirs, feature_vectors], -1)
        else:
            raise ValueError(self.mode)
        n = len(self.layers)
        for l, layer in enumerate(self.layers):
            h = layer(h)
            if l < n - 1:
                h = torch.relu(h)
        return torch.sigmoid(h) if self.squeeze_out else h


class BackgroundNeRF(nn.Module):
    """NeRF++ background MLP over (inverted-sphere 4-D coordinates, view
    dirs); returns (alpha_raw [N, 1], rgb_raw [N, 3]).  The vanilla-NeRF
    layout, skip quirk included, in f32."""

    def __init__(self, D=8, W=256, output_ch=4, skips=(4,), use_viewdirs=False):
        super().__init__()
        del output_ch
        cfg = get_cfg()
        self.D, self.W = D, W
        self.skips = tuple(skips)
        self.use_viewdirs = use_viewdirs
        self.pos_encoder = build_from_cfg(cfg.encoder.nerf_pos_encoder,
                                          ENCODERS)
        self.dir_encoder = build_from_cfg(cfg.encoder.nerf_dir_encoder,
                                          ENCODERS)
        in_dim = self.pos_encoder.out_dim
        dims = [(in_dim, W)] + [(W + in_dim, W) if i in self.skips else (W, W)
                                for i in range(D - 1)]
        self.pts_linears = nn.ModuleList([Linear(i, o) for i, o in dims])
        self.feature_linear = Linear(W, W)
        self.alpha_linear = Linear(W, 1)
        self.views_linear = Linear(self.dir_encoder.out_dim + W, W // 2)
        self.rgb_linear = Linear(W // 2, 3)

    def reset_parameters(self, generator: torch.Generator):
        for layer in (*self.pts_linears, self.feature_linear,
                      self.alpha_linear, self.views_linear, self.rgb_linear):
            _zero_bias_(layer, generator)

    def forward(self, pts, dirs):
        pts_f = self.pos_encoder(pts)
        dirs_f = self.dir_encoder(dirs)
        h = pts_f
        for i, layer in enumerate(self.pts_linears):
            h = torch.relu(layer(h))
            if i in self.skips:
                h = torch.cat([pts_f, h], dim=-1)
        alpha = self.alpha_linear(h)
        feature = self.feature_linear(h)
        h = torch.relu(self.views_linear(torch.cat([feature, dirs_f], dim=-1)))
        return alpha, self.rgb_linear(h)


class SingleVarianceNetwork(nn.Module):
    """The learned global inverse standard deviation exp(10 * variance)."""

    def __init__(self, init_val):
        super().__init__()
        self.init_val = float(init_val)
        self.variance = nn.Parameter(torch.tensor(self.init_val))

    def reset_parameters(self, generator: torch.Generator):
        del generator
        with torch.no_grad():
            self.variance.fill_(self.init_val)

    def inv_s(self):
        return torch.exp(self.variance * 10.0)


@NETWORKS.register_module()
class NeuS(nn.Module):
    def __init__(self, nerf_network, sdf_network, variance_network,
                 rendering_network, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.nerf_outside = BackgroundNeRF(**nerf_network)
        self.sdf_network = SDFNetwork(**sdf_network)
        self.deviation_network = SingleVarianceNetwork(**variance_network)
        self.color_network = RenderingNetwork(**rendering_network)
        if device is not None:
            self.to(device)
        if generator is not None:
            self.reset_parameters(generator)

    def reset_parameters(self, generator: torch.Generator):
        """Draw every parameter from ``generator`` (on its device)."""
        for net in (self.nerf_outside, self.sdf_network,
                    self.deviation_network, self.color_network):
            net.reset_parameters(generator)

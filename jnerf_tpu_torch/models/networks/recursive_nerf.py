"""Recursive-NeRF: a growing LOD tree of MLP segments with uncertainty-gated
early termination.

Counterpart of `jnerf_tpu/models/networks/recursive_nerf.py`.  The tree is
static (head_num fixes the topology) and every node's segment runs on the
full point batch; routing is a mask, so "early termination" picks which
node's output each point keeps rather than skipping compute.  The JAX
function's quirks are kept: the output heads read ``h[:, :W]`` after a
skip concat (the encoding and the first W - 63 hidden units), the residual
is added only where the shapes agree, children overwrite their parent's
output by mask, and ties of ``argmin`` over the anchors pick the first
child.  The anchors are parameters without gradient (the JAX tree holds
them beside the weights, where Adam sees a zero gradient): `split_anchors`
overwrites them and they are saved with the weights.  Layer names are the
JAX tree's keys (`utils/convert.py`).  Every product is f32.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .mlp import Linear, init_linear_


def _tree(head_num: int):
    """(children per node, linears per node, skip positions)."""
    if head_num == 1:
        return [[1], [2], [3], []], [2, 2, 4, 4], [4]
    if head_num == 4:
        return (
            [[1, 2], [3, 4], [5, 6], [7], [8], [9], [10], [], [], [], []],
            [2, 2, 2, 4, 4, 4, 4, 4, 4, 4, 4],
            [6, 10, 14, 18],
        )
    if head_num == 8:
        return (
            [[1, 2], [3, 4], [5, 6], [7, 8], [9, 10], [11, 12], [13, 14],
             [], [], [], [], [], [], [], []],
            [2, 2, 2, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4, 4],
            [6, 10, 14, 18],
        )
    raise ValueError(f"unsupported head_num {head_num}")


def positional_encoding(x: torch.Tensor, multires: int) -> torch.Tensor:
    """[x, sin(x 2^f) for f, then cos], frequency-major within each."""
    freqs = 2.0 ** torch.arange(multires, dtype=torch.float32,
                                device=x.device)
    xb = (x[..., None, :] * freqs[:, None]).reshape(*x.shape[:-1], -1)
    return torch.cat([x, torch.sin(xb), torch.cos(xb)], dim=-1)


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt((x * x).sum(-1))


class _RGBHead(nn.Module):
    def __init__(self, W: int, in_ch_views: int):
        super().__init__()
        self.feat = Linear(W, W // 2)
        self.view = Linear(W // 2 + in_ch_views, 3)


class RecursiveNeRF(nn.Module):
    def __init__(self, head_num=8, W=256, multires=10, multires_views=4,
                 threshold=3e-2, generator: torch.Generator | None = None):
        super().__init__()
        self.sons, self.nlinears, self.skip_linear = _tree(head_num)
        self.node_num = len(self.sons)
        self.W = W
        self.threshold = threshold
        self.multires = multires
        self.multires_views = multires_views
        self.in_ch = 3 + 6 * multires
        self.in_ch_views = 3 + 6 * multires_views
        # depth (stage level) of each node
        self.depth = [0] * self.node_num
        for i, sons in enumerate(self.sons):
            for s in sons:
                self.depth[s] = self.depth[i] + 1
        self.max_depth = max(self.depth)
        # linear index ranges per node
        self.node_linears = []
        k = 0
        for n in self.nlinears:
            self.node_linears.append(list(range(k, k + n)))
            k += n
        self.linear_num = k

        lins = []
        for li in range(self.linear_num):
            in_dim = self.in_ch if li == 0 else W
            if li - 1 in self.skip_linear:  # layer after a skip concat
                in_dim = W + self.in_ch
            lins.append(Linear(in_dim, W))
        self.linears = nn.ModuleList(lins)
        self.confidence = nn.ModuleList(
            [Linear(W, 1) for _ in range(self.node_num)])
        self.alpha = nn.ModuleList(
            [Linear(W, 1) for _ in range(self.node_num)])
        self.rgb = nn.ModuleList(
            [_RGBHead(W, self.in_ch_views) for _ in range(self.node_num)])
        # routing anchors: [n_children, 3] a node (k-means-updated)
        self.anchors = nn.ParameterList([
            nn.Parameter(torch.zeros((max(len(s), 1), 3)),
                         requires_grad=False) for s in self.sons])
        if generator is not None:
            self.reset_parameters(generator)

    def reset_parameters(self, generator: torch.Generator):
        """w ~ U(+-sqrt(6 / in)), b = 0, as the JAX init; anchors zero."""
        for m in self.modules():
            if isinstance(m, Linear):
                init_linear_(m.w, generator)
                nn.init.zeros_(m.b)
        for a in self.anchors:
            nn.init.zeros_(a)

    def _node_out(self, t, h, views_enc):
        conf = self.confidence[t](h)[:, 0]
        alpha = self.alpha[t](h)
        feat = torch.relu(self.rgb[t].feat(h))
        rgb = self.rgb[t].view(torch.cat([feat, views_enc], -1))
        return conf, torch.cat([rgb, alpha], -1)

    def forward(self, pts, views, max_level=None, masks=None):
        """pts [N, 3], views [N, 3] -> (raw [N, 4], uncertainty [N]).

        max_level gates recursion depth (the step1/2/3 schedule); points
        whose node confidence is already below threshold keep shallow
        outputs even when deeper levels exist.  A dict passed as
        ``masks`` receives each visited node's routing mask [N] bool.
        """
        if max_level is None:
            max_level = self.max_depth
        pts_enc = positional_encoding(pts, self.multires)
        views_enc = positional_encoding(
            views / _norm(views)[:, None], self.multires_views)
        n = pts.shape[0]

        out = pts.new_zeros((n, 4))
        uncert = pts.new_zeros((n,))
        # per-node hidden state and assignment mask, walked in index order
        # (parents precede children by construction).
        h_in = {0: pts_enc}
        mask = {0: torch.ones((n,), dtype=torch.bool, device=pts.device)}
        identity = {0: None}
        for t in range(self.node_num):
            if t not in h_in or self.depth[t] > max_level:
                continue
            h = h_in[t]
            ident = identity[t]
            for j, li in enumerate(self.node_linears[t]):
                h = self.linears[li](h)
                if t == 0 and j == 0:
                    ident = h
                if j == len(self.node_linears[t]) - 1 and ident is not None \
                        and ident.shape == h.shape:
                    h = h + ident
                h = torch.relu(h)
                if li in self.skip_linear:
                    h = torch.cat([pts_enc, h], -1)
            conf, node_out = self._node_out(
                t, h[:, : self.W] if h.shape[-1] != self.W else h, views_enc)
            m = mask[t]
            if masks is not None:
                masks[t] = m
            # This node's output stands for its points (children overwrite
            # unless the point is confident or recursion is capped).
            out = torch.where(m[:, None], node_out, out)
            uncert = torch.where(m, conf, uncert)

            sons = self.sons[t]
            if sons and self.depth[t] < max_level:
                # Route uncertain points to the nearest-anchor child.
                anchors = self.anchors[t]  # [n_sons, 3]
                d = _norm(pts[:, None, :] - anchors[None, : len(sons)])
                nearest = torch.argmin(d, dim=-1)
                go_deeper = m & (conf > self.threshold)
                for si, s in enumerate(sons):
                    child_mask = go_deeper & (nearest == si)
                    mask[s] = mask[s] | child_mask if s in mask else child_mask
                    h_in[s] = h
                    identity[s] = h
        return out, uncert


def kmeans(points: np.ndarray, k: int, iters: int = 10, seed: int = 0):
    """Plain numpy k-means for anchor placement (do_kmeans parity)."""
    rng = np.random.default_rng(seed)
    if len(points) < k:
        points = np.concatenate(
            [points, rng.normal(scale=0.1, size=(k, 3)).astype(points.dtype)]
        )
    centers = points[rng.choice(len(points), k, replace=False)]
    for _ in range(iters):
        d = np.linalg.norm(points[:, None] - centers[None], axis=-1)
        assign = d.argmin(1)
        for j in range(k):
            sel = points[assign == j]
            if len(sel):
                centers[j] = sel.mean(0)
    return centers


@torch.no_grad()
def split_anchors(model: RecursiveNeRF, sample_pts, uncert, threshold=None):
    """Place child anchors by k-means over high-uncertainty points, in
    place on ``model``'s anchors; returns the model."""
    threshold = threshold if threshold is not None else model.threshold
    pts = np.asarray(torch.as_tensor(sample_pts).detach().cpu())
    u = np.asarray(torch.as_tensor(uncert).detach().cpu())
    hard = pts[u > threshold]
    if len(hard) == 0:
        hard = pts
    for t, sons in enumerate(model.sons):
        if sons:
            model.anchors[t].copy_(torch.from_numpy(
                kmeans(hard, max(len(sons), 1), seed=t).astype(np.float32)))
    return model

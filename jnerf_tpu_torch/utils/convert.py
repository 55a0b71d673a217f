"""Convert parameters between the JAX package's trees and the port.

The JAX package keeps the NGP parameters as a tree of arrays::

    {"pos_encoder": {"grid": [n_entries, F]},
     "dir_encoder": {},
     "density_mlp": [{"w": [in, out]}, ...],
     "rgb_mlp": [{"w": [in, out]}, ...]}

and the port's `NGPNetworks` as a ``state_dict`` with the same arrays
under ``pos_encoder.grid``, ``density_mlp.weights.<i>`` and
``rgb_mlp.weights.<i>`` (weights are ``[in, out]`` in both).

The vanilla-NeRF tree (``pts_linears`` [{w, b}, ...], ``feature_linear``,
``alpha_linear``, ``views_linear``, ``rgb_linear``) has the port's
`OriginNeRFNetworks` names, its path joined with dots (``pts_linears.0.w``).
The NeuS tree (``sdf`` and ``color`` [{w, b}, ...], ``nerf``: a vanilla
tree, ``variance``: {variance}) maps onto the port's `NeuS` submodules
``sdf_network.layers``, ``color_network.layers``, ``nerf_outside`` and
``deviation_network``.  The Mip-NeRF tree (``trunk`` [{w, b}, ...],
``density``, ``bottleneck``, ``condition`` [...], ``rgb``) has
`MipNerfMLP`'s names, joined with dots as the vanilla tree's, and so
does the Recursive-NeRF tree (``linears``, ``confidence``, ``alpha``,
``rgb`` [{feat, view}], ``anchors`` [arrays]) with `RecursiveNeRF`'s.  The
pixelNeRF tree ``{"enc": {stem, conv<i>a, conv<i>b}, "net": {...}}`` maps
onto a ``ModuleDict(enc=ImageEncoder, net=PixelNeRF)``: ``net`` by the
same names, ``enc``'s conv weights from HWIO to the port's OIHW.  Every
function takes and gives numpy arrays or tensors, never JAX arrays, so
that this module imports no JAX.
"""

from __future__ import annotations

import numpy as np
import torch

_MLPS = ("density_mlp", "rgb_mlp")


# NeuS: the JAX tree's top-level keys -> the port's module prefixes.
_NEUS_PREFIX = {"nerf": "nerf_outside", "sdf": "sdf_network.layers",
                "color": "color_network.layers", "variance": "deviation_network"}


def _flatten(tree, prefix, out):
    """A tree of dicts and lists -> ``{"a.0.w": tensor}`` into ``out``."""
    items = (tree.items() if isinstance(tree, dict)
             else enumerate(tree) if isinstance(tree, (list, tuple)) else None)
    if items is None:
        out[prefix] = torch.as_tensor(np.array(tree, np.float32))
        return out
    for k, v in items:
        _flatten(v, f"{prefix}.{k}" if prefix else str(k), out)
    return out


def _unflatten(flat):
    """``{"a.0.w": array}`` -> a tree of dicts, with lists where every key
    of a level is an index."""
    tree = {}
    for name, v in flat.items():
        node, *path, leaf = [tree] + name.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = v

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(tree)


def jax_params_to_state_dict(params) -> dict:
    """A JAX params tree (NGP, vanilla NeRF, NeuS, Mip-NeRF, pixelNeRF or
    Recursive-NeRF; numpy leaves) -> the port's state_dict."""
    if "pos_encoder" not in params:
        if set(params) == {"enc", "net"}:
            out = _flatten(params["net"], "net", {})
            for k, w in params["enc"].items():  # HWIO -> OIHW
                out[f"enc.{k}"] = torch.as_tensor(np.ascontiguousarray(
                    np.array(w, np.float32).transpose(3, 2, 0, 1)))
            return out
        if set(params) == set(_NEUS_PREFIX):
            out = {}
            for key, prefix in _NEUS_PREFIX.items():
                _flatten(params[key], prefix, out)
            return out
        return _flatten(params, "", {})
    sd = {"pos_encoder.grid": torch.as_tensor(
        np.array(params["pos_encoder"]["grid"], np.float32))}
    for name in _MLPS:
        for i, layer in enumerate(params[name]):
            if set(layer) != {"w"}:
                raise ValueError(f"{name}[{i}] has {sorted(layer)}: the NGP "
                                 "networks are bias-free")
            sd[f"{name}.weights.{i}"] = torch.as_tensor(
                np.array(layer["w"], np.float32))
    return sd


def state_dict_to_jax_params(sd) -> dict:
    """The port's state_dict -> the JAX params tree (numpy leaves)."""

    def np32(t):
        return t.detach().cpu().numpy().astype(np.float32)

    if "pos_encoder.grid" not in sd:
        flat = {k: np32(v) for k, v in sd.items()}
        if any(k.startswith("enc.") for k in flat):
            enc = {k[4:]: np.ascontiguousarray(v.transpose(2, 3, 1, 0))
                   for k, v in flat.items() if k.startswith("enc.")}
            return {"enc": enc,  # OIHW -> HWIO
                    "net": _unflatten({k[4:]: v for k, v in flat.items()
                                       if k.startswith("net.")})}
        if any(k.startswith("sdf_network.") for k in flat):
            return {key: _unflatten({k[len(prefix) + 1:]: v
                                     for k, v in flat.items()
                                     if k.startswith(prefix + ".")})
                    for key, prefix in _NEUS_PREFIX.items()}
        return _unflatten(flat)
    params = {"pos_encoder": {"grid": np32(sd["pos_encoder.grid"])},
              "dir_encoder": {}}
    for name in _MLPS:
        n = sum(1 for k in sd if k.startswith(f"{name}.weights."))
        params[name] = [{"w": np32(sd[f"{name}.weights.{i}"])}
                        for i in range(n)]
    return params

"""Convert NGP parameters between the JAX package's tree and the port.

The JAX package keeps the NGP parameters as a tree of arrays::

    {"pos_encoder": {"grid": [n_entries, F]},
     "dir_encoder": {},
     "density_mlp": [{"w": [in, out]}, ...],
     "rgb_mlp": [{"w": [in, out]}, ...]}

and the port's `NGPNetworks` as a ``state_dict`` with the same arrays
under ``pos_encoder.grid``, ``density_mlp.weights.<i>`` and
``rgb_mlp.weights.<i>`` (weights are ``[in, out]`` in both).  Both
functions take and give numpy arrays or tensors, never JAX arrays, so that
this module imports no JAX.
"""

from __future__ import annotations

import numpy as np
import torch

_MLPS = ("density_mlp", "rgb_mlp")


def jax_params_to_state_dict(params) -> dict:
    """JAX NGP params tree (numpy leaves) -> the port's state_dict."""
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
    """The port's state_dict -> the JAX NGP params tree (numpy leaves)."""

    def np32(t):
        return t.detach().cpu().numpy().astype(np.float32)

    params = {"pos_encoder": {"grid": np32(sd["pos_encoder.grid"])},
              "dir_encoder": {}}
    for name in _MLPS:
        n = sum(1 for k in sd if k.startswith(f"{name}.weights."))
        params[name] = [{"w": np32(sd[f"{name}.weights.{i}"])}
                        for i in range(n)]
    return params

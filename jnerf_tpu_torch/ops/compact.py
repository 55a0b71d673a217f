"""Ragged sample compaction + segmented compositing.

Same semantics as `jnerf_tpu/ops/compact.py` (the reference's
`compacted_coord.h` global cap): the valid samples of the fixed [R, S]
march output are packed into a dense [M] buffer, so the model runs on the
M kept samples only; samples past the cap M are dropped and their rays
flagged truncated.

The TPU version builds the per-lane ray id with a scatter-max + blocked
cummax and composites with a flagged associative scan.  Here the ray id is
the same scatter-max + ``torch.cummax``, and compositing scatters the M
lanes back into an [R, S] grid (each ray's kept samples are a leading run
of its row) and takes a plain cumprod along S: the same products in the
same order, with no segmented scan needed.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .composite import network_to_density, transmittance


class CompactInfo(NamedTuple):
    idx: torch.Tensor         # [M] int64 flat (r*S + s) source slot per lane
    slot_valid: torch.Tensor  # [M] bool: lane holds a real (kept) sample
    offsets: torch.Tensor     # [R+1] int64 exclusive prefix (uncapped)
    counts: torch.Tensor      # [R] int64 kept (leading-run) samples per ray
    truncated: torch.Tensor   # [R] bool: ray lost samples to the M cap
    ray: torch.Tensor         # [M] int64 ray id per lane
    within: torch.Tensor      # [M] int64 position of the lane in its ray
    n_samples: int            # S of the [R, S] layout the lanes came from


def compact_indices(valid: torch.Tensor, m: int) -> CompactInfo:
    """Build gather indices packing the valid samples of [R, S] into [M].

    ``valid`` is a leading run per ray (the march emits samples in t-order
    and clips suffixes); post-hole stragglers are dropped by the cumprod.
    """
    r, s = valid.shape
    dev = valid.device
    lead = torch.cumprod(valid.to(torch.int64), dim=1)  # [R, S]
    counts = lead.sum(dim=1)  # [R]
    offsets = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                         torch.cumsum(counts, dim=0)])  # [R+1]
    total = offsets[-1]

    # Ray id per compact lane: each non-empty ray's index lands at its
    # start lane (an empty ray shares its start with the next non-empty
    # ray; max keeps that owner), then cummax fills the segment.  Lane m
    # is the drop slot for starts at or past the cap.
    starts = torch.where((counts > 0) & (offsets[:-1] < m), offsets[:-1],
                         torch.full_like(counts, m))
    seed = torch.zeros(m + 1, dtype=torch.int64, device=dev).scatter_reduce(
        0, starts, torch.arange(r, device=dev), reduce="amax")
    ray = torch.cummax(seed[:m], dim=0).values  # [M]

    lane = torch.arange(m, device=dev)
    within = lane - offsets[ray]
    slot_valid = lane < torch.clamp(total, max=m)
    idx = torch.clamp(ray * s + torch.clamp(within, 0, s - 1), 0, r * s - 1)
    return CompactInfo(
        idx=idx,
        slot_valid=slot_valid,
        offsets=offsets,
        counts=counts,
        truncated=offsets[1:] > m,
        ray=ray,
        within=within,
        n_samples=s,
    )


def render_rays_compact(raw, dts, info: CompactInfo, background=None,
                        apply_bg_on_truncated=False):
    """Composite compacted [M, 4] network outputs to per-ray RGB.

    Matches `jnerf_tpu/ops/compact.py::render_rays_compact`: the same
    activations and 1e-10 transmittance floor over each ray's kept
    samples.  ``dts`` is [M].  Rays cut by the global cap skip the
    background term (`calc_rgb.h:68-71`) unless ``apply_bg_on_truncated``.
    Returns (rgb [R, 3], opacity [R]).
    """
    n_rays, n_samples = info.counts.shape[0], info.n_samples
    rgb = torch.sigmoid(raw[:, :3])  # [M, 3]
    sigma = network_to_density(raw[:, 3])
    alpha = torch.where(info.slot_valid, 1.0 - torch.exp(-sigma * dts),
                        torch.zeros_like(dts))
    # Kept lanes go to (ray, within) of an [R, S + 1] grid; padding lanes
    # to the spare column S, which is dropped.  Untouched cells hold
    # alpha 0, whose factor 1 - 0 + 1e-10 rounds to exactly 1 in f32.
    col = torch.where(info.slot_valid, info.within,
                      torch.full_like(info.within, n_samples))
    grid_alpha = raw.new_zeros((n_rays, n_samples + 1)).index_put(
        (info.ray, col), alpha)[:, :n_samples]
    grid_rgb = raw.new_zeros((n_rays, n_samples + 1, 3)).index_put(
        (info.ray, col), rgb)[:, :n_samples]
    trans = transmittance(grid_alpha)
    t_excl = torch.cat([torch.ones_like(trans[:, :1]), trans[:, :-1]], dim=1)
    weights = grid_alpha * t_excl  # [R, S]
    rgb_ray = torch.sum(weights[..., None] * grid_rgb, dim=1)
    t_final = trans[:, -1]
    if background is not None:
        bg_weight = t_final
        if not apply_bg_on_truncated:
            bg_weight = torch.where(info.truncated, torch.zeros_like(t_final),
                                    t_final)
        rgb_ray = rgb_ray + bg_weight[:, None] * background
    return rgb_ray, 1.0 - t_final

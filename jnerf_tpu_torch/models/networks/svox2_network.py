"""Plenoxels SparseGrid: a density + SH-coefficient voxel grid.

Counterpart of `jnerf_tpu/models/networks/svox2_network.py`.  The grid's
tables are the module's parameters, named as the JAX params dict: dense,
``density`` [X, Y, Z] and ``sh`` [X, Y, Z, 3 * basis_dim]; sparse (after
an upsample past ``sparse_cell_threshold`` cells, or a sparse ``.npz``),
``density_data`` [cap] and ``sh_data`` [cap, C].  The sparse grid's
``links`` [X, Y, Z] int32 and ``cells`` [cap] int32 are buffers.

The sparse upsample builds the mask, ``links`` and the density resize on
the grid's device (537 MB each at 512^3), not through the JAX code's numpy
round trip, and interpolates SH only at active cells, in chunks of 2^20.
It keeps the JAX code's two mappings: density goes through the
half-pixel trilinear resize, SH is sampled from the old grid at
``ids * (old - 1) / (new - 1)``.  ``save_npz`` / ``load_npz`` use svox2's
schema (f16 data; dense identity links or the sparse links).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from jnerf_tpu_torch.ops.voxel_grid import (
    VoxelGridSpec,
    corner_gather,
    corners,
    dilate_mask,
    render_rays_grid,
    render_rays_grid_sparse,
    sparse_capacity,
    sparse_links,
    total_variation,
    total_variation_sparse,
    trilinear_sample,
    trilinear_sample_sparse,
    upsample_grid,
)
from jnerf_tpu_torch.utils.common import device_const
from jnerf_tpu_torch.utils.config import get_cfg
from jnerf_tpu_torch.utils.registry import NETWORKS

SH_CHUNK = 1 << 20  # active cells interpolated at once in the sparse upsample


@NETWORKS.register_module()
class SparseGrid(nn.Module):
    def __init__(self, reso=128, radius=1.0, center=(0.0, 0.0, 0.0),
                 basis_dim=9, basis_reso=16, use_z_order=False,
                 use_sphere_bound=False, nosphereinit=False, device="cuda",
                 **_unused):
        super().__init__()
        cfg = get_cfg()
        self.device = torch.device(device)
        if isinstance(reso, int):
            reso = (reso,) * 3
        self.spec = VoxelGridSpec(tuple(int(r) for r in reso), int(basis_dim))
        self._set_frame(np.broadcast_to(np.asarray(radius, np.float32), (3,)),
                        np.asarray(center, np.float32))
        self.init_sigma = float(cfg.init_sigma or 0.1)
        self.sparse = False
        self.sparse_cell_threshold = int(cfg.sparse_cell_threshold or (300 ** 3))
        self.density_thresh = float(
            cfg.density_thresh if cfg.density_thresh is not None else 1.0)
        self.sparse_dilate = int(
            cfg.sparse_dilate if cfg.sparse_dilate is not None else 2)
        X, Y, Z = self.spec.reso
        self.density = nn.Parameter(torch.full(
            (X, Y, Z), self.init_sigma, dtype=torch.float32, device=self.device))
        self.sh = nn.Parameter(torch.zeros(
            (X, Y, Z, self.spec.sh_channels), dtype=torch.float32,
            device=self.device))

    def _set_frame(self, radius, center):
        """world -> grid: g = (x * scaling + offset) * (reso - 1)."""
        self.radius = np.array(radius, np.float32)
        self.center = np.array(center, np.float32)
        self._offset = torch.from_numpy(
            0.5 * (1.0 - self.center / self.radius)).to(self.device)
        self._scaling = torch.from_numpy(0.5 / self.radius).to(self.device)

    def tables(self) -> dict:
        """The trainable tables by name (the JAX params dict's keys)."""
        return dict(self.named_parameters())

    def _replace_tables(self, tables: dict, links=None, cells=None):
        for name in ("density", "sh", "density_data", "sh_data"):
            if name in self._parameters:
                delattr(self, name)
        for name, t in tables.items():
            setattr(self, name, nn.Parameter(t.to(self.device)))
        for name, t in (("links", links), ("cells", cells)):
            if name in self._buffers:
                delattr(self, name)
            if t is not None:
                self.register_buffer(name, t.to(self.device))
        self.sparse = links is not None

    # ---------------------------------------------------------- transforms
    def _reso(self):
        return device_const(tuple(float(r) for r in self.spec.reso),
                            self.device)

    def world2grid_points(self, pts):
        return (pts * self._scaling + self._offset) * (self._reso() - 1)

    def world2grid_rays(self, rays_o, rays_d):
        """Grid-space origins and directions, and the world length of one
        grid unit along each ray [R, 1] (the compositing's delta scale)."""
        reso = self._reso()
        scale = self._scaling * (reso - 1)
        go = (rays_o * self._scaling + self._offset) * (reso - 1)
        gd = rays_d * scale
        norm_gd = torch.linalg.norm(gd, dim=-1, keepdim=True)
        world_per_grid = (torch.linalg.norm(rays_d, dim=-1, keepdim=True)
                          / norm_gd)
        return go, gd, world_per_grid

    # ------------------------------------------------------------ queries
    def sample(self, pts_world):
        """(sigma [N], sh [N, C]) at world points."""
        gpts = self.world2grid_points(pts_world)
        if self.sparse:
            return trilinear_sample_sparse(self.spec, self.links,
                                           self.density_data, self.sh_data,
                                           gpts)
        return trilinear_sample(self.spec, self.density, self.sh, gpts)

    def n_samples_for(self, step_size):
        """Samples a ray: the grid's diagonal over ``step_size`` (float64)."""
        return int(np.ceil(np.linalg.norm(self.spec.reso) / step_size))

    def volume_render(self, rays_o, rays_d, n_samples=None, step_size=0.5,
                      background_brightness=1.0, sigma_thresh=1e-8):
        """World-space rays -> rgb [R, 3]."""
        go, gd, world_per_grid = self.world2grid_rays(rays_o, rays_d)
        gdn = gd / torch.linalg.norm(gd, dim=-1, keepdim=True)
        if n_samples is None:
            n_samples = self.n_samples_for(step_size)
        delta_scale = world_per_grid[:, 0]
        if self.sparse:
            return render_rays_grid_sparse(
                self.spec, self.links, self.density_data, self.sh_data, go,
                gdn, n_samples, step_size, background_brightness,
                sigma_thresh, delta_scale=delta_scale)
        return render_rays_grid(
            self.spec, self.density, self.sh, go, gdn, n_samples, step_size,
            background_brightness, sigma_thresh, delta_scale=delta_scale)

    # ---------------------------------------------------------------- regs
    def tv(self, n_subset=1 << 18, ridx=None, generator=None):
        """TV of the density: exact when dense, over ``n_subset`` table
        rows (``ridx``, or drawn from ``generator``) when sparse."""
        if self.sparse:
            return total_variation_sparse(self.spec, self.links, self.cells,
                                          self.density_data, n_subset,
                                          ridx=ridx, generator=generator)
        return total_variation(self.density)

    def tv_color(self, n_subset=1 << 16, ridx=None, generator=None):
        """TV of the SH coefficients, as `tv`."""
        if self.sparse:
            return total_variation_sparse(self.spec, self.links, self.cells,
                                          self.sh_data, n_subset, ridx=ridx,
                                          generator=generator)
        return total_variation(self.sh)

    # ------------------------------------------------------------- resize
    @torch.no_grad()
    def upsample(self, new_reso):
        """Trilinear resize to ``new_reso``; beyond
        ``sparse_cell_threshold`` cells also sparsify: threshold the
        resized density at ``density_thresh``, dilate the mask
        ``sparse_dilate`` times and keep only active cells' data.  The
        tables are replaced (optimizer state must be made anew)."""
        if isinstance(new_reso, int):
            new_reso = (new_reso,) * 3
        new_reso = tuple(int(r) for r in new_reso)
        if self.sparse:
            raise NotImplementedError("re-sparsifying a sparse grid")
        old_spec = self.spec
        density_old, sh_old = self.density.detach(), self.sh.detach()
        self.spec = VoxelGridSpec(new_reso, old_spec.basis_dim)
        if self.spec.n_cells <= self.sparse_cell_threshold:
            density, sh = upsample_grid(density_old, sh_old, new_reso)
            self._replace_tables({"density": density, "sh": sh})
            return
        density = F.interpolate(density_old[None, None], size=new_reso,
                                mode="trilinear", align_corners=False)[0, 0]
        mask = dilate_mask(density > self.density_thresh, self.sparse_dilate)
        del density_old
        links, cells, active = sparse_links(mask)
        del mask
        n, cap = active.numel(), cells.shape[0]
        ddata = torch.zeros((cap,), dtype=torch.float32, device=self.device)
        ddata[:n] = density.reshape(-1)[active]
        del density
        sdata = self._interp_sh(sh_old, old_spec, active, cap)
        self._replace_tables({"density_data": ddata, "sh_data": sdata},
                             links=links, cells=cells)

    def _interp_sh(self, sh_old, old_spec, active, cap):
        """SH [cap, C] sampled from the old grid at the active new cells'
        positions ``ids * (old - 1) / (new - 1)``, in chunks."""
        X, Y, Z = self.spec.reso
        C = self.spec.sh_channels
        sdata = torch.zeros((cap, C), dtype=torch.float32, device=self.device)
        scale = ((torch.tensor(old_spec.reso, dtype=torch.float32) - 1)
                 / (torch.tensor(self.spec.reso, dtype=torch.float32) - 1)
                 ).to(self.device)
        table = sh_old.reshape(old_spec.n_cells, C)
        for lo in range(0, active.numel(), SH_CHUNK):
            ids = active[lo:lo + SH_CHUNK]
            gpts = torch.stack([ids // (Y * Z), (ids // Z) % Y, ids % Z],
                               -1).to(torch.float32) * scale
            sdata[lo:lo + ids.numel()] = corner_gather(
                *corners(old_spec, gpts), table)[0]
        return sdata

    # ------------------------------------------------------------ save/load
    def save_npz(self, path):
        """svox2's npz schema: the sparse grid's links and its active rows,
        or the dense grid with identity links; f16 data."""
        X, Y, Z = self.spec.reso
        if self.sparse:
            links = self.links.cpu().numpy().astype(np.int32)
            n = int(links.max()) + 1
            density = self.density_data.detach()[:n].cpu().numpy()
            sh = self.sh_data.detach()[:n].cpu().numpy()
        else:
            links = np.arange(self.spec.n_cells, dtype=np.int32).reshape(X, Y, Z)
            density = self.density.detach().cpu().numpy()
            sh = self.sh.detach().cpu().numpy()
        np.savez_compressed(
            path, radius=self.radius, center=self.center, links=links,
            density_data=density.reshape(-1, 1).astype(np.float16),
            sh_data=sh.reshape(-1, self.spec.sh_channels).astype(np.float16),
            basis_type=1)

    def load_npz(self, path):
        """Load a grid in svox2's schema: sparse tables when its cell count
        exceeds ``sparse_cell_threshold``, otherwise dense grids."""
        z = np.load(path)
        links = z["links"]
        reso = links.shape
        n_cells = reso[0] * reso[1] * reso[2]
        self.spec = VoxelGridSpec(tuple(int(r) for r in reso),
                                  z["sh_data"].shape[1] // 3)
        self._set_frame(z["radius"], z["center"])
        flat_links = links.reshape(-1)
        valid = flat_links >= 0
        dd = z["density_data"].astype(np.float32)
        sd = z["sh_data"].astype(np.float32)
        if n_cells > self.sparse_cell_threshold:
            n = dd.shape[0]
            cap = sparse_capacity(n)
            ddata = np.zeros((cap,), np.float32)
            sdata = np.zeros((cap, sd.shape[1]), np.float32)
            ddata[:n] = dd[:, 0]
            sdata[:n] = sd
            cells = np.full((cap,), -1, np.int32)
            cells[flat_links[valid]] = np.flatnonzero(valid).astype(np.int32)
            self._replace_tables(
                {"density_data": torch.from_numpy(ddata),
                 "sh_data": torch.from_numpy(sdata)},
                links=torch.from_numpy(links.astype(np.int32)),
                cells=torch.from_numpy(cells))
            return
        density = np.zeros((n_cells,), np.float32)
        sh = np.zeros((n_cells, sd.shape[1]), np.float32)
        density[valid] = dd[flat_links[valid], 0]
        sh[valid] = sd[flat_links[valid]]
        self._replace_tables({
            "density": torch.from_numpy(density.reshape(reso)),
            "sh": torch.from_numpy(sh.reshape(*reso, -1))})

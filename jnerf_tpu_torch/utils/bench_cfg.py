"""Programmatic configs for benchmarking and harness entry points.

Same config as `jnerf_tpu/utils/bench_cfg.py`: an ngp_base-equivalent
config (`projects/ngp/configs/ngp_base.py`) over the in-memory
SyntheticSpheresDataset, at full benchmark scale or a tiny test scale.
"""

from __future__ import annotations

from jnerf_tpu_torch.utils.config import Config, get_cfg


def ngp_synthetic_cfg(
    *,
    n_images=16,
    H=256,
    W=256,
    n_rays_per_batch=4096,
    target_batch_size=1 << 18,
    grid_size=128,
    nerf_steps=1024,
    hash_levels=16,
    hash_features=2,
    log2_hashmap_size=19,
    tot_train_steps=1000,
    fp16=True,
    seed=42,
    use_fully=True,
    scene="spheres",
    ssaa=1,
    n_val=2,
) -> Config:
    """Install and return the global config for a synthetic NGP run."""
    cfg = get_cfg()
    cfg.clear()
    wrap = Config._wrap
    ds = dict(
        type="SyntheticSpheresDataset",
        n_images=n_images,
        H=H,
        W=W,
        batch_size=n_rays_per_batch,
        scene=scene,
        ssaa=ssaa,
    )
    cfg.update(
        wrap(dict(
            exp_name="bench",
            log_dir="./logs",
            sampler=dict(type="DensityGridSampler", update_den_freq=16),
            encoder=dict(
                pos_encoder=dict(
                    type="HashEncoder",
                    n_levels=hash_levels,
                    n_features_per_level=hash_features,
                    log2_hashmap_size=log2_hashmap_size,
                ),
                dir_encoder=dict(type="SHEncoder"),
            ),
            model=dict(type="NGPNetworks", use_fully=use_fully),
            loss=dict(type="HuberLoss", delta=0.1),
            optim=dict(type="Adam", lr=1e-1, eps=1e-15, betas=(0.9, 0.99)),
            ema=dict(type="EMA", decay=0.95),
            expdecay=dict(
                type="ExpDecay",
                decay_start=20_000,
                decay_interval=10_000,
                decay_base=0.33,
                decay_end=None,
            ),
            dataset=dict(
                train=dict(ds, mode="train"),
                val=dict(ds, mode="val", n_images=n_val),
                test=dict(ds, mode="test", n_images=2),
            ),
            tot_train_steps=tot_train_steps,
            background_color=[0, 0, 0],
            hash_func="p0 ^ p1 * 19349663 ^ p2 * 83492791",
            cone_angle_constant=0.00390625,
            near_distance=0.2,
            n_rays_per_batch=n_rays_per_batch,
            n_training_steps=16,
            target_batch_size=target_batch_size,
            const_dt=True,
            fp16=fp16,
            load_ckpt=False,
            ckpt_path=None,
            alpha_image=False,
            grid_size=grid_size,
            nerf_steps=nerf_steps,
            seed=seed,
            name="bench",
            work_dir="work_dirs/bench",
        ))
    )
    return cfg

"""The port's CLI entry point: `tools/run_net.py` with PyTorch on the card.

    python -m jnerf_tpu_torch.tools.run_net --config-file \\
        projects/ngp/configs/ngp_base.py --task train [--device cuda|cpu]

The JAX CLI's flags (``--config-file``, ``--task {train,test,render,
validate_mesh}``, ``--save_dir``, ``--type {novel_view,mesh}``,
``--mcube_threshold``, ``--runner``) and its runner choice
(`select_runner_name`: an explicit ``runner`` config key or flag wins,
otherwise the config's sampler and model types decide), plus ``--device``
(``cuda``, the default, refuses to run without a card; ``cpu`` runs every
kernel's plain twin).  ``train``, ``test`` and ``render`` drive the port's
`Runner` (NGP and vanilla NeRF); ``--type mesh`` (or ``runner =
"NeuSRunner"``) selects `NeuSRunner`, whose ``train`` and
``validate_mesh`` (world space, 512^3, ``--mcube_threshold``) it runs; a
``MipSampler`` config selects `MipRunner` (``train``, ``test``), a
``SparseGrid`` config `Svox2Runner` (``train``).  A task the chosen runner
lacks exits with the JAX CLI's message.  Where the JAX CLI prints its
backend, this prints the card's name and power limit.
"""

from __future__ import annotations

import argparse
import subprocess

RUNNERS = ("Runner", "NeuSRunner", "MipRunner", "Svox2Runner")


def select_runner_name(cfg, type_arg: str) -> str:
    """Explicit ``runner`` config key wins; otherwise infer from the config."""
    if cfg.runner:
        return str(cfg.runner)
    if type_arg == "mesh":
        return "NeuSRunner"
    sampler_type = (cfg.sampler or {}).get("type", "")
    model_type = (cfg.model or {}).get("type", "")
    if sampler_type == "MipSampler":
        return "MipRunner"
    if model_type == "SparseGrid":
        return "Svox2Runner"
    return "Runner"


def device_line(device: str) -> str:
    """What the run computes on: the card's name and power limit as
    nvidia-smi gives them, or the CPU."""
    import torch

    if device == "cpu":
        return "device: cpu (the kernels' plain PyTorch twins)"
    if not torch.cuda.is_available():
        raise SystemExit("--device cuda: CUDA is not available (use --device "
                         "cpu to run the plain twins on the CPU)")
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60)
        card = out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        card = f"{torch.cuda.get_device_name(0)}, power limit not read"
    return f"device: cuda, {card}"


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--config-file", default="", metavar="FILE",
                        help="path to config file")
    parser.add_argument("--task", default="train", type=str,
                        choices=["train", "test", "render", "validate_mesh"])
    parser.add_argument("--save_dir", default="", type=str)
    parser.add_argument("--type", default="novel_view", type=str,
                        choices=["novel_view", "mesh"])
    parser.add_argument("--mcube_threshold", default=0.0, type=float)
    parser.add_argument("--runner", default="", type=str,
                        help="override runner class (" + ", ".join(RUNNERS)
                        + ")")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="cuda (the default) or cpu")
    return parser.parse_args(argv)


def main(argv=None):
    """Run one task; returns (the runner, what the task returned: the test
    PSNR for Runner's train and for test, the last loss for MipRunner's and
    Svox2Runner's train, the mp4's path for render, the PLY's path for
    validate_mesh)."""
    args = parse_args(argv)
    if not args.config_file:
        raise SystemExit("--config-file is required")
    print(device_line(args.device), flush=True)
    from jnerf_tpu_torch.utils.config import get_cfg, init_cfg

    init_cfg(args.config_file)
    name = args.runner or select_runner_name(get_cfg(), args.type)
    if name not in RUNNERS:
        raise SystemExit(f"unknown runner {name!r} (config key 'runner')")
    from jnerf_tpu_torch import runner as runners

    if name == "NeuSRunner":
        runner = runners.NeuSRunner(is_continue=(args.task == "validate_mesh"),
                                    device=args.device)
    else:
        runner = getattr(runners, name)(device=args.device)

    if args.task == "train":
        out = runner.train()
    elif args.task == "validate_mesh":
        if not hasattr(runner, "validate_mesh"):
            raise SystemExit(f"{name} does not implement task 'validate_mesh'")
        out = runner.validate_mesh(world_space=True, resolution=512,
                                   threshold=args.mcube_threshold)
        print(out, flush=True)
    elif not hasattr(runner, args.task):
        raise SystemExit(f"{name} does not implement task {args.task!r}")
    elif args.task == "test":
        out = runner.test(load_ckpt=True)
    else:
        out = runner.render(save_path=args.save_dir or None)
        print(out, flush=True)
    return runner, out


if __name__ == "__main__":
    main()

"""The card's counterparts of the archived TPU probes (`tools/archive/`),
run as ``python3 -m jnerf_tpu_torch.tools.archive.<name>``.

The nine that make ``pallas_call``s (``probe_{rmw,scatter,scatter2,loop,
final,round2,tpu,tpu2,bwd_var}``) run them as the envelope kernels K1-K4
(`ops/envelope.py`) and their XLA parts as PyTorch calls printed as
library yardsticks, each line followed by its rate, its bytes and its
bound (`common.py`).

The other 17 (``probe_{march,fused_mlp,f4,ab,step3,step_parts,gather,
tpu3,scatter3,vmem,nbr,nbr2,fwd2,bwd_debug,nan_hard,compile}`` and
``profile_step``) run the archive's sections on the port's own ops,
sampler, runner and kernels F, B, F-MLP, B-MLP and D-MLP, or time the
library's gathers and scatter-adds where the archive timed XLA's; a
section that measures only TPU or XLA machinery prints that it has no
counterpart.  Each takes its archived file's arguments plus ``--cpu``.
"""

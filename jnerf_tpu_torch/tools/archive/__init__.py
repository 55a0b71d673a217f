"""The card's counterparts of the archived TPU envelope probes
(``tools/archive/probe_{rmw,scatter,scatter2,loop,final,round2,tpu,tpu2,
bwd_var}.py``), run as ``python3 -m jnerf_tpu_torch.tools.archive.<name>``.

Each takes its archived file's arguments plus ``--cpu``, runs the file's
``pallas_call``s as the envelope kernels K1-K4 (`ops/envelope.py`) and its
XLA parts as PyTorch calls printed as library yardsticks, and prints the
file's lines under its names, each followed by its rate, its bytes and its
bound (`common.py`).
"""

"""The benchmark of the PyTorch + CUDA port (`jnerf_tpu_torch`).

``python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of `BENCHMARK.json` once; `cells.py` says
which files a cell is made of.  Nothing here imports JAX or the JAX
package; `program.py` is the only module that imports the port.
"""

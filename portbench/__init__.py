"""The benchmark of the PyTorch port (``torch_ekpose_tpu_torch``) on one
H100: ``python -m portbench.run --workload <cell> --seed <n> --seconds
<s> --trace <0|1>``. ``BENCHMARK.json`` at the checkout's root names the
cells; each configuration, traffic mix, cell's limits and per-layer
metric is a file of its own here (``catalog.py``)."""

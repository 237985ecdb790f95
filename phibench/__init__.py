"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python3 phibench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json`` once and prints one JSON line. Each
configuration, traffic mix and metric is a file of its own under this
folder, found by the name that ``BENCHMARK.json`` gives it: see ``spec.py``.
"""

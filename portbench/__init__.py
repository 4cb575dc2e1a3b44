"""The benchmark of the PyTorch and CUDA port (``gypsum_tpu_torch``).

``python3 -m portbench --workload <cell> --seed <n> --seconds <s> --trace 0|1``
runs one cell of ``BENCHMARK.json`` once and prints one JSON result line;
``README.md`` beside this file says how cells, traffic mixes and per-layer
metrics are added as files.
"""

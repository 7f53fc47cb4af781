"""The benchmark of the PyTorch and CUDA port (dlrm_tpu_torch).

`python3 port_bench/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of BENCHMARK.json on the card and prints one
JSON line. Everything that belongs to one configuration, traffic mix,
driver or per-layer metric is a file of its own, found by the name
BENCHMARK.json gives it (see core.py).
"""

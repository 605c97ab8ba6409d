"""The benchmark of ``repro_torch``, the PyTorch and CUDA port, on one
NVIDIA H100: ``python perfbench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` runs one cell once and prints one JSON
result line. See ``BENCHMARK.json`` at the checkout's root."""

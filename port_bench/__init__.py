"""The benchmark of the PyTorch and CUDA port (``e2e_tts_tpu_torch``) on one
NVIDIA H100: ``python3 -m port_bench.run --workload <name> --seed <n>
--seconds <s> --trace <0|1>``.  ``BENCHMARK.json`` at the repository's root
names its cells; ``harness.py`` says where each piece lives."""

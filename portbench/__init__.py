"""The benchmark of the PyTorch/H100 port, `omni_avsr_tpu_torch`: run a
cell with `python3 -m portbench.run --workload <name> --seed <n> --seconds
<s> --trace <0|1>` from the repository root (see BENCHMARK.json)."""

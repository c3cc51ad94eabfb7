"""The benchmark of riemannhamiltonianmontecarlo_tpu_torch on one NVIDIA H100.

``python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of the root ``BENCHMARK.json`` once and prints one JSON line.
Everything a cell needs is found by name: its configuration under
``configs/``, its traffic mix under ``traffic/``, the comparison's limits under
``limits/``, the model family's driver under ``families/``, the step's
operation count under ``flops/`` and each per-layer metric's reader under
``metrics/`` (README.md).  The yardsticks (``yardstick/``) and the plain
reference (``reference/``) are frozen here, so a change to the program cannot
move them.
"""

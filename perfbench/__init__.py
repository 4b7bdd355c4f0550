"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line. Everything a cell needs is found by name: its file under
``workloads/``, its configuration under ``configs/``, the entry that its
window drives under ``entries/`` and each metric's reader under
``metrics/``. The yardstick (input generators, the plain references under
``reference/``, operation and byte counts, the table of peaks) lives here
and imports nothing of the program, which is measured, not trusted.
"""

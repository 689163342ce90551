"""The benchmark of ``mld_tpu_torch`` on one NVIDIA H100.

``run.py`` runs one cell once (``python benchmark/run.py --workload <name>
--seed <n> --seconds <s> --trace <0|1>``). Every configuration, traffic mix,
cell, kernel count and per-layer metric is a file of its own that the
harness finds by the name ``BENCHMARK.json`` gives it: ``configs/``,
``traffic/``, ``workloads/``, ``kernels/``, ``metrics/``. ``reference/``
is the plain-PyTorch model that decides ``correct``; it imports nothing of
the port.
"""

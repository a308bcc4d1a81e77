"""The benchmark of ``tricolo_tpu_torch`` on an NVIDIA GPU.

One command runs one cell of ``BENCHMARK.json`` once::

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell names is found by name under this folder
(``benchmark.spec``): its configuration in ``configs/<name>.json``, its
traffic in ``traffic/<name>.json`` (with the generator module that file
names), the limits of its correctness check in ``limits/<cell>.json`` and
each per-layer metric's reader in ``metrics/<name>.py``. The plain f32
reference that decides ``correct`` is ``reference/``: it imports nothing of
the program. See README.md.
"""

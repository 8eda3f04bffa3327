"""End-to-end benchmark of ``monkey_moore_tpu_torch`` on one CUDA card.

``python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``.  Everything a cell
needs is found by name: its configuration in ``configs/<name>.json``, its
traffic mix in ``traffic/<name>.json`` and each metric's reader in
``metrics/<name>.py``.  The plain reference (``reference.py``) and the
comparison that decides ``correct`` (``check.py``) import nothing of the
program.
"""

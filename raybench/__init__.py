"""The benchmark of ``ceres_tpu_torch`` on one NVIDIA card.

``python raybench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` and prints one JSON
line. Everything a cell needs is found by name: its configuration in
``configs/``, its traffic mix in ``traffic/``, its limits in ``cells/``
and each per-layer metric's reader in ``metrics/`` (see README.md).

Nothing here imports ``jax`` or the JAX package; ``reference.py``, the
plain renderer that decides ``correct``, imports nothing of the port.
"""

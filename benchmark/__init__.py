"""The benchmark of ``mpc_tpu_torch`` on NVIDIA GPUs.

``python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell of ``BENCHMARK.json``.  Everything a cell needs is found by
name: its configuration in ``configs/<name>.json`` (whose ``kind`` names a
module of ``kinds/`` that builds the world, drives the port and holds the
plain reference), its cell file ``workloads/<name>.json``, its traffic mix
``traffic/<name>.json`` and each metric's reader ``metrics/<name>.py``.
Nothing here imports ``jax`` or the JAX package ``mpc_tpu``.
"""

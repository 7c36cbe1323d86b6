"""Benchmark of the PyTorch/CUDA port (``repro_torch``): a harvested node's
invoker serving a backlog through ``ContinuousEngine``.

``run.py`` runs one cell (a configuration under a traffic mix, both named in
``BENCHMARK.json``) once and prints one JSON line. Everything that belongs
to one configuration, traffic mix, metric or limit is a file of its own
under ``configs/``, ``traffic/``, ``metrics/``, ``limits/``, found by name.
The plain float32 references are under ``reference/``; nothing here imports
``jax`` or the JAX package.
"""

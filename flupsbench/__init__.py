"""The benchmark of ``repro_torch``, the PyTorch and CUDA port of the FLUPS
reproduction: time-stepped Poisson solves on one or four H100s.

``run.py`` is the entry; ``BENCHMARK.json`` at the root of the checkout
names the cells, and every configuration, traffic mix, metric reader and
plain reference is a file of its own here, found by its name
(``catalog``).  Nothing here imports ``jax`` or the JAX package ``repro``.
"""

"""The benchmark of the PyTorch and CUDA port (``sparseharness_tpu_torch``).

``run.py`` runs one cell of ``BENCHMARK.json`` once. Everything that
belongs to one configuration, traffic mix or per-layer metric sits in a
file of its own, found by the name that ``BENCHMARK.json`` gives it:
``configs/<config>.json`` (which names its generator,
``graphs/<generator>.py``), ``traffic/<traffic>.json``,
``limits/<cell>.json`` and ``metrics/<metric>.py``. The plain reference
that decides ``correct`` is under ``reference/``.
"""

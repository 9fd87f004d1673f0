"""The benchmark of the PyTorch and CUDA port (``repro_torch``): co-located
online and offline serving on one H100, measured at the client.

``run.py`` runs one cell of ``BENCHMARK.json``; ``sweep.py`` finds a cell's
knee; ``control.py`` reads the numbers that set a cell's correctness limit.
Everything a configuration, a traffic mix, a cell or a per-layer metric
needs sits in a file of its own (``configs/``, ``traffic/``, ``cells/``,
``metrics/``), found by the name that ``BENCHMARK.json`` gives it.
"""

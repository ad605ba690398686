"""The benchmark of ``repro_torch`` (the PyTorch and CUDA port of
PairwiseHist) on one H100: cells of ``BENCHMARK.json``, driven by data.

``run.py`` is the entry point; ``spec`` resolves a cell's configuration
(``configs/``), its table (``tables/``), its traffic mix (``traffic/``) with
the run loop the mix names (``loops/``) and the per-layer metric readers
(``metrics/``) by name; ``common`` holds what the loops share; ``check`` and
``reference/`` decide ``correct``; ``trace`` reads the device.
"""

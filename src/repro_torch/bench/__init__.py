"""The port's benchmark entry points (``python -m repro_torch.bench.run``).

Importing a module here does no work; each suite runs in its ``run``.
"""

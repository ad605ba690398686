"""Launch entry points of the port: the LM serving and training command
lines (``python -m repro_torch.launch.serve``, ``... .launch.train``)."""

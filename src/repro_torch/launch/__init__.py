"""Launch entry points of the port: the LM serving command line
(``python -m repro_torch.launch.serve``)."""

"""PyTorch/CUDA port of the PairwiseHist system (``src/repro`` is the
reference). Entry points run on the CUDA device unless the caller passes
``device="cpu"``; see ``repro_torch.device.resolve_device``."""

# Generalized Deduplication compression substrate (GreedyGD, §3 + Fig. 2/3).
from repro_torch.gd.preprocess import preprocess_table, Preprocessed  # noqa: F401
from repro_torch.gd.greedygd import GreedyGD, CompressedTable  # noqa: F401

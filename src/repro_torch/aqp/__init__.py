# End-to-end AQP framework (Fig. 2): ingestion -> GreedyGD -> PairwiseHist ->
# query execution; plus ground truth, datasets and query generation.
from repro_torch.aqp.engine import AQPFramework  # noqa: F401
from repro_torch.aqp.exact import ExactEngine  # noqa: F401

"""Multi-table AQP serving subsystem: catalog + streaming admission +
batch scheduler + caches + telemetry.

The port of ``repro.serve.aqp``. Turns the single-table ``AQPFramework``
into a multi-tenant query server: ``AQPServer.submit`` enqueues without
blocking and returns a ``QueryFuture``; a ``StreamingAdmission`` worker
drains the queue into plan-shape waves whose hot path is one fused CUDA
kernel launch per group (GROUP BY queries included, via planning-time leaf
expansion). See ``docs/serving.md`` for the full reference.
"""
from repro_torch.core.query import (AdmissionRejected,  # noqa: F401
                                    DeadlineExceeded, QueryError)
from repro_torch.serve.aqp import faults  # noqa: F401
from repro_torch.serve.aqp.cache import LRUCache, normalize_sql  # noqa: F401
from repro_torch.serve.aqp.catalog import (ColdTable,  # noqa: F401
                                           TableCatalog,
                                           TableQuarantinedError)
from repro_torch.serve.aqp.metrics import (AdmissionMetrics,  # noqa: F401
                                           FaultMetrics, Metrics,
                                           TableMetrics)
from repro_torch.serve.aqp.scheduler import (BatchScheduler,  # noqa: F401
                                             StreamingAdmission)
from repro_torch.serve.aqp.server import AQPServer, QueryFuture  # noqa: F401

"""Online serving: bucket ladder and its CUDA graphs, deadline
micro-batcher, registry, supervised dispatch, server and metrics."""

from hydragnn_tpu_torch.serve.batcher import (  # noqa: F401
    MicroBatchQueue,
    Overloaded,
    ServerClosed,
)
from hydragnn_tpu_torch.serve.buckets import Bucket, BucketGraphCache, build_bucket_ladder, route  # noqa: F401
from hydragnn_tpu_torch.serve.metrics import ServeMetrics  # noqa: F401
from hydragnn_tpu_torch.serve.registry import (  # noqa: F401
    ModelRegistry,
    ServedModel,
    load_served_variables,
    structural_fingerprint,
)
from hydragnn_tpu_torch.serve.server import (  # noqa: F401
    ModelServer,
    Oversize,
    ReloadFailed,
    RequestFailed,
    ServeConfig,
    request_to_dict,
)
from hydragnn_tpu_torch.serve.supervise import DispatchSupervisor  # noqa: F401

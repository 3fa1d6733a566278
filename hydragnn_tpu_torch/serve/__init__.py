"""Online serving: bucket ladder, deadline micro-batcher, registry,
server and metrics."""

from hydragnn_tpu_torch.serve.batcher import (  # noqa: F401
    MicroBatchQueue,
    Overloaded,
    ServerClosed,
)
from hydragnn_tpu_torch.serve.buckets import Bucket, build_bucket_ladder, route  # noqa: F401
from hydragnn_tpu_torch.serve.metrics import ServeMetrics  # noqa: F401
from hydragnn_tpu_torch.serve.registry import ModelRegistry, ServedModel  # noqa: F401
from hydragnn_tpu_torch.serve.server import (  # noqa: F401
    ModelServer,
    Oversize,
    RequestFailed,
    ServeConfig,
    request_to_dict,
)

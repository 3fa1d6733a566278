"""Fault tolerance of the training loop (the port's counterpart of
``hydragnn_tpu/resilience/``): so far the non-finite sentry."""

from hydragnn_tpu_torch.resilience.sentry import NonFiniteRollbackExhausted, NonFiniteSentry  # noqa: F401

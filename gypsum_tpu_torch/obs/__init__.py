"""Observability: metrics, per-satellite visualizers, web dashboard."""

from gypsum_tpu_torch.obs.metrics import ReceiverMetrics  # noqa: F401

"""Serving layer: concurrent, deadline-aware butterfly analytics over
resident graphs. See :mod:`repro_torch.serve.service`."""
from ..core.resilience import (  # noqa: F401 - the service's typed errors
    AdmissionRejected,
    Deadline,
    DeadlineExceeded,
)
from .admission import AdmissionController
from .breaker import CircuitBreaker
from .cache import ResultCache
from .service import (
    ButterflyService,
    Query,
    QUERY_KINDS,
    ServiceReport,
    ServiceResponse,
)

__all__ = [
    "AdmissionController",
    "AdmissionRejected",
    "ButterflyService",
    "CircuitBreaker",
    "Deadline",
    "DeadlineExceeded",
    "Query",
    "QUERY_KINDS",
    "ResultCache",
    "ServiceReport",
    "ServiceResponse",
]

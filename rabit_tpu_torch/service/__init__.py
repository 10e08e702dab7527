"""The multi-tenant collective service.

The port's own copy of ``rabit_tpu/service``: one long-lived control plane,
many concurrent jobs.  Each job is a tracker partition served on one
reactor (:class:`CollectiveService`); admission checks keys and quotas a
tenant (:class:`JobRegistry`); every job's journal records go into one
journal (:class:`ServiceState`); and warm pooled workers are leased to one
job after another (:class:`PooledWorker`).
"""

from rabit_tpu_torch.service.pool import PooledWorker
from rabit_tpu_torch.service.registry import JobRegistry, tenant_of
from rabit_tpu_torch.service.service import AdmissionRefused, CollectiveService
from rabit_tpu_torch.service.state import ServiceState

__all__ = [
    "AdmissionRefused",
    "CollectiveService",
    "JobRegistry",
    "PooledWorker",
    "ServiceState",
    "tenant_of",
]

"""Multi-tenant QoS (twin of :mod:`mpi4dl_tpu.tenancy`): the tenant model,
token-bucket quota admission and the deficit-weighted round robin
(:mod:`.model`). The fleet's dedupe (``dedupe.py``) is ROADMAP queue 1
item 9."""

from mpi4dl_tpu_torch.tenancy.model import (  # noqa: F401
    DEFAULT_TENANT,
    DeficitRoundRobin,
    QuotaExceededError,
    Tenant,
    TenantAdmission,
    TokenBucket,
    default_tenants,
    normalize_tenants,
    parse_tenants,
)

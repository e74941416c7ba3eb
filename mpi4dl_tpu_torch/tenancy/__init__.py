"""Multi-tenant QoS (twin of :mod:`mpi4dl_tpu.tenancy`): the tenant model,
token-bucket quota admission and the deficit-weighted round robin
(:mod:`.model`), and the fleet's rendezvous pinning of a trace id to a
replica (:mod:`.dedupe`)."""

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
from mpi4dl_tpu_torch.tenancy.dedupe import pin_order, pin_replica  # noqa: F401

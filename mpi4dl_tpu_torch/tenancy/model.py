"""Tenant model, token-bucket quotas, and the DWRR fair-fill policy.

(Twin of ``mpi4dl_tpu/tenancy/model.py``, copied: the port imports nothing of the JAX
package.)

A :class:`Tenant` is to capacity what an
:class:`~mpi4dl_tpu_torch.serve.scheduler.SLOClass` is to latency: a named
policy identity that rides every metric label and CLI token. The spec
grammar mirrors ``parse_slo_classes``::

    NAME=RPS:BURST[:WEIGHT][@CLASSES]

    bulk=200:400            # 200 req/s sustained, bursts to 400
    tight=50:100:4@tight    # 4x the fair-share weight, tight class only
    free=none               # declared but unlimited (weight/classes ok)

``RPS`` is the sustained refill rate of the tenant's token bucket,
``BURST`` its capacity (tokens). ``WEIGHT`` is the tenant's share in
the scheduler's deficit-weighted-round-robin batch fill (default 1).
``@CLASSES`` (``+``-separated) restricts which SLO classes the tenant
may submit to; empty means all. A tenant named ``default`` is always
present (implicitly unlimited) — untenanted submissions land there, so
a tenancy-enabled engine serves legacy clients unchanged.

Enforcement is :class:`TenantAdmission`: one instance per admission
edge (the fleet router's front door and the engine's ``submit``). An
over-quota admission raises :class:`QuotaExceededError` carrying
``retry_after_s`` computed from the bucket's OWN refill rate — not the
batch-cadence EMA the queue-full path uses — so a compliant retrying
client converges to exactly its quota instead of thundering.
"""

from __future__ import annotations

import dataclasses
import re
import threading
import time

#: Tenant names must survive as metric label values and CLI tokens.
_NAME_RE = re.compile(r"^[a-z][a-z0-9_]*$")

DEFAULT_TENANT = "default"


class QuotaExceededError(RuntimeError):
    """A tenant exceeded its token-bucket quota at an admission edge.

    Deliberately NOT a :class:`~mpi4dl_tpu_torch.serve.QueueFullError`
    subclass (that would import the engine into this leaf module): it
    carries the same ``retry_after_s``/``slo_class``/``shed`` attribute
    shape so every retry/backoff path can treat the two uniformly, plus
    the ``tenant`` that blew its budget — the label forensics and 429
    payloads carry."""

    def __init__(self, msg: str, tenant: str,
                 retry_after_s: "float | None" = None,
                 slo_class: "str | None" = None):
        super().__init__(msg)
        self.tenant = tenant
        self.retry_after_s = retry_after_s
        self.slo_class = slo_class
        self.shed = True


@dataclasses.dataclass(frozen=True)
class Tenant:
    """One named tenant: quota + fair-share weight + class allowlist.

    rate_rps: sustained token refill rate; None = unlimited (no bucket).
    burst: bucket capacity in tokens; defaults to ``rate_rps`` (one
        second of sustained rate) when a rate is set.
    weight: deficit-round-robin share in batch formation (> 0).
    classes: SLO class names this tenant may submit to; () = all.
    """

    name: str
    rate_rps: "float | None" = None
    burst: "float | None" = None
    weight: float = 1.0
    classes: "tuple[str, ...]" = ()

    def __post_init__(self):
        if not _NAME_RE.match(self.name):
            raise ValueError(
                f"tenant name {self.name!r} must match {_NAME_RE.pattern}"
            )
        if self.rate_rps is not None and self.rate_rps <= 0:
            raise ValueError(
                f"tenant {self.name}: rate must be > 0, got {self.rate_rps}"
            )
        if self.rate_rps is not None and self.burst is None:
            object.__setattr__(self, "burst", float(self.rate_rps))
        if self.burst is not None and self.burst < 1:
            raise ValueError(
                f"tenant {self.name}: burst must be >= 1, got {self.burst}"
            )
        if self.weight <= 0:
            raise ValueError(
                f"tenant {self.name}: weight must be > 0, got {self.weight}"
            )


def default_tenants() -> "tuple[Tenant, ...]":
    """The implicit single-tenant configuration: one unlimited
    ``default`` tenant — exactly the pre-tenancy behavior."""
    return (Tenant(DEFAULT_TENANT),)


def parse_tenants(spec: str) -> "tuple[Tenant, ...]":
    """``"bulk=200:400,tight=50:100:4@tight"`` → Tenant tuple.

    Per tenant: ``NAME=RPS:BURST[:WEIGHT][@CLASSES]`` — ``RPS`` of
    ``none`` declares an unlimited tenant (``BURST`` then omitted:
    ``NAME=none[:WEIGHT][@CLASSES]``). A ``default`` tenant is appended
    (unlimited) when the spec does not declare one, so untenanted
    submissions always resolve."""
    out = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(
                f"bad tenant {part!r}: expected NAME=RPS:BURST"
                "[:WEIGHT][@CLASSES]"
            )
        name, rest = part.split("=", 1)
        classes: "tuple[str, ...]" = ()
        if "@" in rest:
            rest, cls = rest.split("@", 1)
            classes = tuple(
                c.strip() for c in cls.split("+") if c.strip()
            )
        toks = [t.strip() for t in rest.split(":")]
        if toks and toks[0] in ("none", ""):
            rate = burst = None
            weight = float(toks[1]) if len(toks) > 1 and toks[1] else 1.0
        else:
            if len(toks) < 2 or not toks[1]:
                raise ValueError(
                    f"tenant {name.strip()!r}: RPS needs a BURST "
                    f"(NAME=RPS:BURST[:WEIGHT]), got {rest!r}"
                )
            rate = float(toks[0])
            burst = float(toks[1])
            weight = float(toks[2]) if len(toks) > 2 and toks[2] else 1.0
        out.append(Tenant(
            name=name.strip(), rate_rps=rate, burst=burst,
            weight=weight, classes=classes,
        ))
    if not out:
        raise ValueError(f"no tenants in {spec!r}")
    names = [t.name for t in out]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate tenant names in {spec!r}")
    if DEFAULT_TENANT not in names:
        out.append(Tenant(DEFAULT_TENANT))
    return tuple(out)


def normalize_tenants(tenants) -> "tuple[Tenant, ...] | None":
    """Constructor input → Tenant tuple, or None (tenancy OFF — the
    zero-overhead path). A string parses; a sequence is validated and
    gains the implicit ``default`` tenant."""
    if tenants is None:
        return None
    if isinstance(tenants, str):
        return parse_tenants(tenants)
    out = list(tenants)
    if not out:
        return None
    names = [t.name for t in out]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate tenant names: {names}")
    if DEFAULT_TENANT not in names:
        out.append(Tenant(DEFAULT_TENANT))
    return tuple(out)


class TokenBucket:
    """Classic token bucket: ``rate_rps`` tokens/s refill up to
    ``burst``. ``try_take`` is the whole API — atomic take-or-hint,
    where the hint is the exact wall time until the missing tokens
    refill (what a compliant client should sleep)."""

    def __init__(self, rate_rps: float, burst: float,
                 clock=time.monotonic):
        self.rate_rps = float(rate_rps)
        self.burst = float(burst)
        self._clock = clock
        self._tokens = float(burst)
        self._stamp = clock()
        self._lock = threading.Lock()

    def try_take(self, n: int = 1) -> "float | None":
        """Take ``n`` tokens: None on success, else the seconds until
        the bucket will hold ``n`` (the ``retry_after_s`` hint)."""
        now = self._clock()
        with self._lock:
            self._tokens = min(
                self.burst,
                self._tokens + (now - self._stamp) * self.rate_rps,
            )
            self._stamp = now
            if self._tokens >= n:
                self._tokens -= n
                return None
            return (n - self._tokens) / self.rate_rps

    def tokens(self) -> float:
        """Current level (refreshed) — the quota gauge's value."""
        now = self._clock()
        with self._lock:
            self._tokens = min(
                self.burst,
                self._tokens + (now - self._stamp) * self.rate_rps,
            )
            self._stamp = now
            return self._tokens


class TenantAdmission:
    """Per-tenant quota + class-allowlist enforcement for one edge.

    One instance guards one admission point (the fleet router's front
    door, or the engine's ``submit``) — each edge refills its own
    buckets, so with R routers a tenant's effective fleet-wide rate is
    R x its configured RPS unless the operator divides the spec (the
    documented per-edge semantics; see docs/SERVING.md).
    """

    def __init__(self, tenants, registry=None, clock=time.monotonic):
        normalized = normalize_tenants(tenants)
        if normalized is None:
            normalized = default_tenants()
        self.tenants = normalized
        self._by_name = {t.name: t for t in self.tenants}
        self._buckets = {
            t.name: TokenBucket(t.rate_rps, t.burst, clock=clock)
            for t in self.tenants if t.rate_rps is not None
        }
        self._m_tokens = self._m_sheds = self._m_admitted = None
        if registry is not None:
            from mpi4dl_tpu_torch import telemetry

            self._m_tokens = telemetry.declare(
                registry, "tenant_quota_tokens"
            )
            self._m_sheds = telemetry.declare(
                registry, "tenant_quota_sheds_total"
            )
            self._m_admitted = telemetry.declare(
                registry, "tenant_admitted_total"
            )
            for name, bucket in self._buckets.items():
                self._m_tokens.set(bucket.tokens(), tenant=name)

    def weights(self) -> "dict[str, float]":
        """Tenant → DWRR weight (the scheduler's fair-fill input)."""
        return {t.name: t.weight for t in self.tenants}

    def resolve(self, name: "str | None") -> Tenant:
        """``tenant`` argument → Tenant. None lands in ``default``;
        unknown names raise — a client/config mismatch is a deployment
        bug and must be loud, not silently billed to default."""
        if name is None:
            return self._by_name[DEFAULT_TENANT]
        ten = self._by_name.get(str(name))
        if ten is None:
            raise ValueError(
                f"unknown tenant {name!r} (configured: "
                f"{sorted(self._by_name)})"
            )
        return ten

    def admit(self, name: "str | None", n: int = 1,
              slo_class: "str | None" = None) -> Tenant:
        """Charge ``n`` requests to the tenant's bucket. Returns the
        resolved Tenant, or raises :class:`QuotaExceededError` with the
        bucket's refill-time hint. Class-allowlist violations raise
        ``ValueError`` (a config bug, not load)."""
        ten = self.resolve(name)
        if ten.classes and slo_class is not None \
                and slo_class not in ten.classes:
            raise ValueError(
                f"tenant {ten.name!r} may not submit to class "
                f"{slo_class!r} (allowed: {list(ten.classes)})"
            )
        bucket = self._buckets.get(ten.name)
        if bucket is not None:
            retry_after = bucket.try_take(n)
            if self._m_tokens is not None:
                self._m_tokens.set(bucket.tokens(), tenant=ten.name)
            if retry_after is not None:
                if self._m_sheds is not None:
                    self._m_sheds.inc(n, tenant=ten.name)
                raise QuotaExceededError(
                    f"tenant {ten.name!r} over quota "
                    f"({bucket.rate_rps:g} rps, burst {bucket.burst:g}); "
                    f"refill in {retry_after:.3f}s",
                    tenant=ten.name, retry_after_s=retry_after,
                    slo_class=slo_class,
                )
        if self._m_admitted is not None:
            self._m_admitted.inc(n, tenant=ten.name)
        return ten

    def state(self) -> dict:
        """The stats()/debugz payload: per-tenant quota config + level."""
        return {
            t.name: {
                "rate_rps": t.rate_rps,
                "burst": t.burst,
                "weight": t.weight,
                "classes": list(t.classes),
                "tokens": (
                    self._buckets[t.name].tokens()
                    if t.name in self._buckets else None
                ),
            }
            for t in self.tenants
        }


class DeficitRoundRobin:
    """Per-request deficit-weighted round robin over tenants.

    Each tenant earns credits proportional to its weight per pointer
    rotation and spends one per dispatched request; a tenant whose
    queue is empty when the pointer passes forfeits its accumulated
    credit (work-conserving: an idle tenant cannot bank a burst).
    Increments are normalized so the smallest weight earns exactly one
    request per rotation — ``pick`` therefore always terminates within
    two rotations when any tenant is active.
    """

    def __init__(self, weights: "dict[str, float]"):
        if not weights:
            raise ValueError("DWRR needs at least one tenant weight")
        self._weights = {t: float(w) for t, w in weights.items()}
        if min(self._weights.values()) <= 0:
            raise ValueError(f"weights must be > 0: {weights}")
        scale = 1.0 / min(self._weights.values())
        self._quantum = {
            t: w * scale for t, w in self._weights.items()
        }
        self._order = list(self._weights)
        self._deficit = {t: 0.0 for t in self._order}
        self._idx = 0

    def pick(self, active) -> "str | None":
        """The tenant the next batch slot goes to, among ``active``
        (tenant names with queued work). None when nothing is active."""
        act = {t for t in active if t in self._deficit}
        if not act:
            return None
        n = len(self._order)
        for _ in range(2 * n + 1):
            t = self._order[self._idx % n]
            if t not in act:
                self._deficit[t] = 0.0
                self._idx += 1
                continue
            if self._deficit[t] >= 1.0:
                # Spend remaining credit before the pointer moves on.
                self._deficit[t] -= 1.0
                return t
            self._deficit[t] += self._quantum[t]
            self._idx += 1
        # Unreachable by construction (min quantum is 1.0); stay safe.
        return sorted(act)[0]

    def state(self) -> dict:
        return {"deficit": dict(self._deficit), "weights": dict(self._weights)}

"""Declarative SLO watchdog over the sliding-window metric plane.

A port of ``sparkdl_tpu.core.slo``. An operator declares objectives over
recent time windows — "queue-wait p99 under a second over the last
30 s", "shed rate near zero", "no breaker trips" — and the telemetry
scope's periodic exporter
(:class:`~sparkdl_tpu_torch.core.telemetry.SnapshotExporter`) evaluates
them at every tick, emitting paired ``slo_breach`` / ``slo_recovered``
health events with log alerts while the process is alive.

- **Rules are declarative and validated at construction.** An
  :class:`SLORule` names a *declared* metric (the
  ``core.telemetry.CANONICAL_METRIC_NAMES`` catalog, or a
  ``sparkdl.health.<event>`` mirror of a constant declared in
  ``core/health.py``) with a stat its instrument kind can produce; a
  typo'd metric raises ``ValueError`` instead of silently never firing.
- **Windowed, not cumulative.** Observations come from
  ``MetricsRegistry.window_snapshot(rule.window_s)``: an old latency
  spike ages out of the verdict.
- **Hold-down, then exactly one pair per episode.** A rule must stay in
  breach for ``for_s`` continuous seconds (as seen by evaluation ticks)
  before ``slo_breach`` fires; the matching ``slo_recovered`` fires on
  the first in-budget evaluation afterwards.
- **Absence of data is not a breach.** A window with no samples observes
  ``None`` for histogram stats (and 0 for counter rates).

The rule builders — :func:`default_rules`, :func:`default_serving_rules`,
:func:`tenant_queue_wait_rules`, :func:`cluster_serving_rules` and the
``federated_*`` variants — are the reference's; the cluster ones name
series that only the (not yet ported) cluster planes record.

Standard library only; imports ``core.telemetry`` for the metric catalog
and ``core.health`` for the event choke point — the telemetry scope
imports THIS module lazily, so there is no cycle.
"""

from __future__ import annotations

import dataclasses
import logging
import operator
from typing import Any, Dict, Optional, Sequence, Tuple

from sparkdl_tpu_torch.core import health, telemetry

logger = logging.getLogger(__name__)

_COMPARATORS = {
    ">": operator.gt,
    ">=": operator.ge,
    "<": operator.lt,
    "<=": operator.le,
}

#: Stats a rule may read, per instrument kind (see :meth:`SLORule.observe`).
_HISTOGRAM_STATS = ("p50", "p95", "p99", "count", "rate_per_s", "min",
                    "max")
_COUNTER_STATS = ("count", "rate_per_s")
_GAUGE_STATS = ("value",)
_STATS = tuple(dict.fromkeys(_HISTOGRAM_STATS + _COUNTER_STATS
                             + _GAUGE_STATS))


def _declared_health_metrics() -> frozenset:
    """Every valid ``sparkdl.health.<event>`` mirror name, derived from
    the UPPERCASE string constants declared in ``core/health.py`` — the
    same set the taxonomy lint trusts."""
    return frozenset(
        telemetry.HEALTH_METRIC_PREFIX + value
        for name, value in vars(health).items()
        if name.isupper() and isinstance(value, str))


@dataclasses.dataclass(frozen=True)
class SLORule:
    """One objective: ``<stat>(metric over window_s) <comparator>
    threshold`` must NOT hold (holding = breaching) for ``for_s``
    continuous seconds.

    ``metric`` must be a declared name — a ``CANONICAL_METRIC_NAMES``
    entry or a ``sparkdl.health.<declared event>`` mirror; anything else
    raises at construction (a typo'd rule must fail loudly, not watch
    nothing forever).
    """

    name: str
    metric: str
    window_s: float
    threshold: float
    comparator: str = ">"
    stat: str = "p99"
    for_s: float = 0.0

    def __post_init__(self) -> None:
        if not self.name:
            raise ValueError("SLORule.name must be non-empty")
        if self.comparator not in _COMPARATORS:
            raise ValueError(
                f"SLORule {self.name!r}: comparator must be one of "
                f"{tuple(_COMPARATORS)}, got {self.comparator!r}")
        if self.stat not in _STATS:
            raise ValueError(
                f"SLORule {self.name!r}: stat must be one of {_STATS}, "
                f"got {self.stat!r}")
        if self.window_s <= 0:
            raise ValueError(
                f"SLORule {self.name!r}: window_s must be > 0, got "
                f"{self.window_s!r}")
        if self.for_s < 0:
            raise ValueError(
                f"SLORule {self.name!r}: for_s must be >= 0, got "
                f"{self.for_s!r}")
        kind = telemetry.CANONICAL_METRIC_KINDS.get(self.metric)
        if kind is None:
            if self.metric in _declared_health_metrics():
                kind = "counter"  # health mirrors are always counters
            else:
                raise ValueError(
                    f"SLORule {self.name!r}: metric {self.metric!r} is "
                    "not a declared name — use a core.telemetry."
                    "CANONICAL_METRIC_NAMES entry or a sparkdl.health."
                    "<event> mirror of a constant declared in "
                    "core/health.py")
        allowed = {"histogram": _HISTOGRAM_STATS,
                   "counter": _COUNTER_STATS,
                   "gauge": _GAUGE_STATS}[kind]
        if self.stat not in allowed:
            # a stat the instrument kind can never produce would observe
            # None forever — watching nothing, silently
            raise ValueError(
                f"SLORule {self.name!r}: stat {self.stat!r} cannot be "
                f"observed on {self.metric!r} (a {kind}); valid stats: "
                f"{allowed}")

    def observe(self, windowed: Dict[str, Any]) -> Optional[float]:
        """Extract this rule's stat from one
        ``MetricsRegistry.window_snapshot`` result; ``None`` when the
        window holds no data for the metric."""
        hist = windowed["histograms"].get(self.metric)
        if hist is not None and self.stat in _HISTOGRAM_STATS:
            return hist.get(self.stat)
        ctr = windowed["counters"].get(self.metric)
        if ctr is not None and self.stat in _COUNTER_STATS:
            return ctr.get(self.stat)
        gauge = windowed["gauges"].get(self.metric)
        if gauge is not None and self.stat == "value":
            return gauge.get("last")
        return None

    def breaching(self, observed: Optional[float]) -> bool:
        if observed is None:
            return False  # no data is never a breach
        return _COMPARATORS[self.comparator](observed, self.threshold)


class _RuleState:
    __slots__ = ("breach_since", "active", "last_observed")

    def __init__(self) -> None:
        self.breach_since: Optional[float] = None
        self.active = False
        self.last_observed: Optional[float] = None


class SLOWatchdog:
    """Evaluates a rule set against a registry's windowed snapshots.

    One instance per telemetry scope (built by ``Telemetry.__enter__``
    when the exporter is on); :meth:`evaluate` is called on every
    exporter tick and at the final flush. Not thread-safe by design —
    only the exporter (one thread, plus the close-time flush under the
    exporter's tick lock) drives it.
    """

    def __init__(self, rules: Optional[Sequence[SLORule]] = None,
                 attribution: Optional[Any] = None) -> None:
        self.rules: Tuple[SLORule, ...] = tuple(
            DEFAULT_RULES if rules is None else rules)
        names = [r.name for r in self.rules]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SLO rule names: {names}")
        self._states = {r.name: _RuleState() for r in self.rules}
        self._capacity_warned: set = set()
        # optional per-worker attribution hook (the reference's federated
        # watchdog): called as attribution(rule) when a breach
        # fires, returning {worker: observed} — the breach event then
        # names WHICH workers drove the cluster-wide verdict, not just
        # the merged number
        self.attribution = attribution

    def evaluate(self, registry: "telemetry.MetricsRegistry",
                 now: Optional[float] = None) -> Dict[str, Any]:
        """One evaluation pass: returns ``{rule: {observed, threshold,
        breached}}`` (the exporter embeds it in each snapshot line) and
        emits the breach/recovery events."""
        if now is None:
            now = telemetry._monotonic()
        snaps: Dict[float, Dict[str, Any]] = {}
        out: Dict[str, Any] = {}
        for rule in self.rules:
            windowed = snaps.get(rule.window_s)
            if windowed is None:
                windowed = snaps[rule.window_s] = \
                    registry.window_snapshot(rule.window_s)
            if (windowed["window_s"] is not None
                    and windowed["window_s"] + 1e-9 < rule.window_s
                    and rule.name not in self._capacity_warned):
                # the registry's ring can't answer the declared window;
                # Telemetry rejects this pairing at construction, but a
                # standalone watchdog must still say so (once), not
                # silently judge over less history than the rule states
                self._capacity_warned.add(rule.name)
                logger.warning(
                    "SLO rule %r window_s=%g exceeds the registry ring "
                    "capacity (%gs); evaluating over the capped window",
                    rule.name, rule.window_s, windowed["window_s"])
            state = self._states[rule.name]
            observed = rule.observe(windowed)
            state.last_observed = observed
            # the offending traces behind a histogram verdict: the
            # in-window tail exemplars (present only on scopes armed
            # with Telemetry(exemplar_k=...)) — a breach names the
            # concrete trace/span ids to chase, not just a number
            hist = windowed["histograms"].get(rule.metric)
            exemplars = (hist or {}).get("exemplars")
            if rule.breaching(observed):
                if state.breach_since is None:
                    state.breach_since = now
                if (not state.active
                        and now - state.breach_since >= rule.for_s):
                    state.active = True
                    extra = ({"exemplars": exemplars} if exemplars
                             else {})
                    if self.attribution is not None:
                        try:
                            extra["workers"] = self.attribution(rule)
                        # best-effort enrichment: the breach fires anyway
                        except Exception:  # noqa: BLE001
                            logger.exception(
                                "SLO breach attribution hook failed "
                                "for rule %r", rule.name)
                    health.record(health.SLO_BREACH, rule=rule.name,
                                  metric=rule.metric, stat=rule.stat,
                                  observed=observed,
                                  threshold=rule.threshold,
                                  window_s=rule.window_s, **extra)
                    logger.warning(
                        "SLO breach %r: %s(%s over %gs) = %.6g %s %.6g "
                        "(held %.3gs)", rule.name, rule.stat, rule.metric,
                        rule.window_s, observed, rule.comparator,
                        rule.threshold, now - state.breach_since)
            else:
                state.breach_since = None
                if state.active:
                    state.active = False
                    health.record(health.SLO_RECOVERED, rule=rule.name,
                                  metric=rule.metric, stat=rule.stat,
                                  observed=observed,
                                  threshold=rule.threshold,
                                  window_s=rule.window_s)
                    logger.warning(
                        "SLO recovered %r: %s(%s over %gs) = %s, back "
                        "within %s %.6g", rule.name, rule.stat,
                        rule.metric, rule.window_s,
                        ("%.6g" % observed) if observed is not None
                        else "no data", rule.comparator, rule.threshold)
            out[rule.name] = {"observed": observed,
                              "threshold": rule.threshold,
                              "breached": state.active}
            if state.active and exemplars:
                out[rule.name]["exemplars"] = exemplars
        return out

    def state(self) -> Dict[str, Dict[str, Any]]:
        """Current per-rule verdicts (for tests and ad-hoc queries)."""
        return {r.name: {"breached": self._states[r.name].active,
                         "observed": self._states[r.name].last_observed}
                for r in self.rules}


# ---------------------------------------------------------------------------
# Default rules: the executor's degradation, observable out of the box
# ---------------------------------------------------------------------------

DEFAULT_WINDOW_S = 30.0
DEFAULT_QUEUE_WAIT_P99_S = 1.0   # executor queue wait must stay sub-second
DEFAULT_SHED_RATE_PER_S = 1.0    # sustained shedding, not a lone blip
DEFAULT_HOLD_S = 0.0


def default_rules(window_s: float = DEFAULT_WINDOW_S,
                  for_s: float = DEFAULT_HOLD_S,
                  queue_wait_p99_s: float = DEFAULT_QUEUE_WAIT_P99_S,
                  shed_rate_per_s: float = DEFAULT_SHED_RATE_PER_S,
                  ) -> Tuple[SLORule, ...]:
    """The shipped rule set, re-parameterized (tests and short-lived
    scopes want second-scale windows; the defaults suit serving)."""
    return (
        # the latency objective: queue-wait p99 over the window
        SLORule("executor_queue_wait_p99",
                metric=telemetry.M_QUEUE_WAIT_S,
                window_s=window_s, threshold=queue_wait_p99_s,
                comparator=">", stat="p99", for_s=for_s),
        # the loss objective: sustained admission shedding
        SLORule("executor_shed_rate",
                metric=telemetry.HEALTH_METRIC_PREFIX
                + health.EXECUTOR_SHED,
                window_s=window_s, threshold=shed_rate_per_s,
                comparator=">=", stat="rate_per_s", for_s=for_s),
        # the availability objective: any breaker trip in the window
        SLORule("executor_breaker_open",
                metric=telemetry.HEALTH_METRIC_PREFIX
                + health.BREAKER_OPEN,
                window_s=window_s, threshold=1.0,
                comparator=">=", stat="count", for_s=for_s),
    )


DEFAULT_RULES: Tuple[SLORule, ...] = default_rules()

# Serving-plane defaults (serving/): the ModelServer's aggregate request-latency objective and its admission
# shed rate. Per-model objectives are built from the deployment's
# latency target at declaration time.
DEFAULT_SERVING_P99_S = 0.5
DEFAULT_SERVING_SHED_RATE_PER_S = 1.0


def default_serving_rules(model_targets: Optional[Dict[str, float]] = None,
                          window_s: float = DEFAULT_WINDOW_S,
                          for_s: float = DEFAULT_HOLD_S,
                          request_p99_s: float = DEFAULT_SERVING_P99_S,
                          shed_rate_per_s: float =
                          DEFAULT_SERVING_SHED_RATE_PER_S,
                          ) -> Tuple[SLORule, ...]:
    """The serving plane's rule set: the aggregate request-latency p99
    and sustained admission shedding, plus ONE latency rule per entry of
    ``model_targets`` (model name -> p99 target in SECONDS). Per-model
    metrics have per-model names (metrics carry no labels), so each
    model rule watches ``sparkdl.serving.request_s.<model>`` — declared
    here via :func:`telemetry.declare_metric`, which is also what makes
    ``SLORule`` construction accept the dynamic name."""
    rules = [
        # the latency objective: end-to-end request p99 over the window
        SLORule("serving_request_p99",
                metric=telemetry.M_SERVING_REQUEST_S,
                window_s=window_s, threshold=request_p99_s,
                comparator=">", stat="p99", for_s=for_s),
        # the loss objective: sustained SLO-aware admission shedding
        SLORule("serving_shed_rate",
                metric=telemetry.HEALTH_METRIC_PREFIX
                + health.SERVING_SHED,
                window_s=window_s, threshold=shed_rate_per_s,
                comparator=">=", stat="rate_per_s", for_s=for_s),
    ]
    for model, target_s in sorted((model_targets or {}).items()):
        metric = telemetry.declare_metric(
            telemetry.serving_request_metric(model), "histogram")
        rules.append(
            SLORule(f"serving_request_p99_{model}", metric=metric,
                    window_s=window_s, threshold=float(target_s),
                    comparator=">", stat="p99", for_s=for_s))
    return tuple(rules)


# A failover is a worker death made invisible — one or two per window is
# the plane doing its job; a sustained rate means replicas are dying
# faster than they respawn and the survivors are absorbing everything.
DEFAULT_SERVING_FAILOVER_RATE_PER_S = 0.5


def cluster_serving_rules(model_targets: Optional[Dict[str, float]] = None,
                          window_s: float = DEFAULT_WINDOW_S,
                          for_s: float = DEFAULT_HOLD_S,
                          request_p99_s: float = DEFAULT_SERVING_P99_S,
                          shed_rate_per_s: float =
                          DEFAULT_SERVING_SHED_RATE_PER_S,
                          failover_rate_per_s: float =
                          DEFAULT_SERVING_FAILOVER_RATE_PER_S,
                          ) -> Tuple[SLORule, ...]:
    """The cluster serving plane's rule set: everything
    :func:`default_serving_rules` watches — in cluster mode every
    request is routed (and its latency observed) coordinator-side, so
    each per-model ``sparkdl.serving.request_s.<model>`` histogram IS
    the per-deployment windowed p99 **across all replicas** — plus a
    sustained-failover rule on the ``serving_failover`` health mirror
    (replicas dying faster than the plane can hide it)."""
    rules = list(default_serving_rules(
        model_targets, window_s=window_s, for_s=for_s,
        request_p99_s=request_p99_s, shed_rate_per_s=shed_rate_per_s))
    rules.append(
        SLORule("serving_failover_rate",
                metric=telemetry.HEALTH_METRIC_PREFIX
                + health.SERVING_FAILOVER,
                window_s=window_s, threshold=failover_rate_per_s,
                comparator=">=", stat="rate_per_s", for_s=for_s))
    return tuple(rules)


def tenant_queue_wait_rules(tenant_targets: Dict[str, float],
                            window_s: float = DEFAULT_WINDOW_S,
                            for_s: float = DEFAULT_HOLD_S,
                            ) -> Tuple[SLORule, ...]:
    """One queue-wait p99 rule per entry of ``tenant_targets`` (tenant
    tag -> p99 target in SECONDS) — the fairness objective of the
    elastic-capacity plane: under sustained overload from one tenant,
    the OTHER tenants' queue-wait p99 staying under target is what
    proves deficit-round-robin is doing its job. Per-tenant metrics have
    per-tenant names (``sparkdl.executor.queue_wait_s.<tenant>``,
    emitted by ``core/executor.py`` for every non-default tenant), so
    each rule watches its tenant's own series — declared here via
    :func:`telemetry.declare_metric`, same dynamic-name pattern as the
    per-model serving rules above."""
    rules = []
    for tenant, target_s in sorted(tenant_targets.items()):
        metric = telemetry.declare_metric(
            telemetry.tenant_queue_wait_metric(tenant), "histogram")
        rules.append(
            SLORule(f"tenant_queue_wait_p99_{tenant}", metric=metric,
                    window_s=window_s, threshold=float(target_s),
                    comparator=">", stat="p99", for_s=for_s))
    return tuple(rules)


# ---------------------------------------------------------------------------
# Federated variants: the SAME objectives evaluated against the coordinator's
# ClusterMetricsView fold instead of a single process's registry — a
# cluster p99 rule watches the MERGED percentile, a rate rule the SUMMED
# rate. Rule names get the cluster_ prefix so a coordinator can run its
# local watchdog and the federated one side by side without colliding
# episode state or event attribution.
# ---------------------------------------------------------------------------

FEDERATED_RULE_PREFIX = "cluster_"


def _federated(rules: Sequence[SLORule]) -> Tuple[SLORule, ...]:
    """Re-name a rule set for federated evaluation (same metrics, same
    thresholds — the VIEW they evaluate against is what changes)."""
    return tuple(
        dataclasses.replace(rule, name=FEDERATED_RULE_PREFIX + rule.name)
        for rule in rules)


def federated_default_rules(window_s: float = DEFAULT_WINDOW_S,
                            for_s: float = DEFAULT_HOLD_S,
                            queue_wait_p99_s: float =
                            DEFAULT_QUEUE_WAIT_P99_S,
                            shed_rate_per_s: float =
                            DEFAULT_SHED_RATE_PER_S,
                            ) -> Tuple[SLORule, ...]:
    """:func:`default_rules` against the federated view: the queue-wait
    objective becomes the CLUSTER-merged p99 (bucket counts summed
    across workers before the estimate), the shed/breaker objectives
    the cluster-summed counts."""
    return _federated(default_rules(
        window_s=window_s, for_s=for_s,
        queue_wait_p99_s=queue_wait_p99_s,
        shed_rate_per_s=shed_rate_per_s))


def federated_tenant_queue_wait_rules(tenant_targets: Dict[str, float],
                                      window_s: float = DEFAULT_WINDOW_S,
                                      for_s: float = DEFAULT_HOLD_S,
                                      ) -> Tuple[SLORule, ...]:
    """:func:`tenant_queue_wait_rules` against the federated view: each
    tenant's objective watches its MERGED cluster-wide p99 (per-tenant
    series federate like any histogram — same dynamic declare)."""
    return _federated(tenant_queue_wait_rules(
        tenant_targets, window_s=window_s, for_s=for_s))


def federated_cluster_serving_rules(model_targets:
                                    Optional[Dict[str, float]] = None,
                                    window_s: float = DEFAULT_WINDOW_S,
                                    for_s: float = DEFAULT_HOLD_S,
                                    request_p99_s: float =
                                    DEFAULT_SERVING_P99_S,
                                    shed_rate_per_s: float =
                                    DEFAULT_SERVING_SHED_RATE_PER_S,
                                    failover_rate_per_s: float =
                                    DEFAULT_SERVING_FAILOVER_RATE_PER_S,
                                    ) -> Tuple[SLORule, ...]:
    """:func:`cluster_serving_rules` against the federated view —
    worker-side serving series (replica-local latencies, shed/failover
    mirrors) fold in beside the coordinator's routed view."""
    return _federated(cluster_serving_rules(
        model_targets, window_s=window_s, for_s=for_s,
        request_p99_s=request_p99_s, shed_rate_per_s=shed_rate_per_s,
        failover_rate_per_s=failover_rate_per_s))

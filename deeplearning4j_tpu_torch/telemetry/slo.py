"""SLO rule engine: the metrics plane turned into verdicts.

The port of ``deeplearning4j_tpu/telemetry/slo.py``: a declarative rule
engine evaluated over the local MetricsRegistry **or** any
registry-snapshot-shaped doc (a ``federate.federate_default()`` merge, a
``history`` sample), each rule carrying an ``ok | warning | firing`` alert
state.

Rule predicates (:class:`SloRule`, ``kind=``):

* ``rate`` — per-second increase of a counter over ``window_s``;
* ``ratio`` — Δnum / Δden of two counters over ``window_s`` (shed ratio);
* ``threshold`` — the current summed gauge value against a bound;
* ``burn_rate`` — the rate must exceed the bound over BOTH a short and a
  long window before firing (a brief spike self-clears, a sustained burn
  pages);
* ``ewma_drift`` — a fast EWMA vs a slow EWMA of a histogram's
  per-interval mean (Δsum/Δcount), firing when their ratio drifts past
  ``fire`` (step-time creep).

Counter deltas are accumulated PER SERIES between consecutive samples; a
series that resets, vanishes (a dead member dropping out of a federated
merge) or newly appears (a member rejoining with its lifetime total)
contributes NOTHING for that interval: never a negative rate, never a
spurious spike. A rule without enough data holds its state.

State transitions count into ``slo_alerts_total{rule,state}``, the current
level rides ``slo_rule_state{rule}`` (0/1/2), and the process-default
engine registers the flight recorder's ``"slo"`` dump section, so a
postmortem dump names the rules that were burning.

``default_rules()`` are the JAX package's, and the port emits the series
of all but one: ``serving_shed_total``/``serving_model_requests_total``,
``recompiles_total``, ``train_numerics_anomalies_total`` (a continuous
trainer's rollback starts from one), ``train_step_seconds`` and
``train_etl_seconds`` from the training and serving tiers,
``fleet_failover_total`` from ``fleet/router.py``,
``continuous_dropped_total`` from ``continuous/trainer.py`` and
``probe_total``/``probe_bad_total`` from ``fleet/prober.py``. The
hostfleet rule reads a series of a tier the port does not have yet and
stays inert (no data: state held at ok). Every rule
excludes ``origin=probe`` series, so synthetic traffic never fires an
organic SLI. Evaluation is host-only: it reads registry snapshots and
never touches a tensor.
"""

from __future__ import annotations

import collections
import threading
import time

from deeplearning4j_tpu_torch.telemetry import registry as _registry

_KINDS = ("rate", "ratio", "threshold", "burn_rate", "ewma_drift")
_STATES = ("ok", "warning", "firing")


class SloRule:
    """One declarative service-level rule: metric selector + predicate.

    ``labels`` filters series (every given pair must match; other labels
    — e.g. the federation's ``instance`` — are ignored, so one rule spans
    the whole merged fleet). ``fire`` / ``warn`` are the predicate bounds
    (``warn=None`` skips the warning state). ``op`` is ``"gt"`` (default)
    or ``"lt"`` for bounds that alarm downward. ``field`` picks the value
    from histogram series (``sum`` or ``count``); scalar series ignore
    it. ``tags`` let decision seams query subsets (the trainer's snapshot
    gate keys on ``"gate"``). ``exclude_labels`` drops series matching
    any given pair before the predicate ever sees them; the default
    ``{"origin": "probe"}`` keeps synthetic prober/health-check traffic
    out of every organic rule (a rule that explicitly selects
    ``origin=probe`` in ``labels`` is exempt from that key — selection
    wins over exclusion)."""

    def __init__(self, name, kind, metric, *, fire, warn=None, labels=None,
                 window_s=300.0, short_window_s=60.0, long_window_s=600.0,
                 den_metric=None, den_labels=None, min_den=1.0,
                 op="gt", alpha_fast=0.3, alpha_slow=0.03,
                 min_intervals=3, field="sum", tags=(), help="",
                 exclude_labels=None):
        if kind not in _KINDS:
            raise ValueError(f"unknown SloRule kind {kind!r}; "
                             f"one of {_KINDS}")
        if kind == "ratio" and not den_metric:
            raise ValueError(f"rule {name!r}: kind='ratio' requires "
                             f"den_metric")
        if op not in ("gt", "lt"):
            raise ValueError(f"rule {name!r}: op must be 'gt' or 'lt'")
        self.name = str(name)
        self.kind = kind
        self.metric = str(metric)
        self.labels = dict(labels or {})
        self.fire = float(fire)
        self.warn = None if warn is None else float(warn)
        self.window_s = float(window_s)
        self.short_window_s = float(short_window_s)
        self.long_window_s = float(long_window_s)
        self.den_metric = den_metric
        self.den_labels = dict(den_labels or {})
        self.min_den = float(min_den)
        self.op = op
        self.alpha_fast = float(alpha_fast)
        self.alpha_slow = float(alpha_slow)
        self.min_intervals = int(min_intervals)
        self.field = field
        self.tags = tuple(tags)
        self.help = help
        if exclude_labels is None:
            exclude_labels = {"origin": "probe"}
        # a key the rule explicitly selects on can't also be excluded
        self.exclude_labels = {k: v for k, v in dict(exclude_labels).items()
                               if k not in self.labels}
        self.den_exclude_labels = {
            k: v for k, v in dict(exclude_labels).items()
            if k not in self.den_labels}

    def describe(self):
        d = {"name": self.name, "kind": self.kind, "metric": self.metric,
             "fire": self.fire, "warn": self.warn, "op": self.op,
             "tags": list(self.tags)}
        if self.labels:
            d["labels"] = dict(self.labels)
        if self.exclude_labels:
            d["exclude_labels"] = dict(self.exclude_labels)
        if self.kind == "ratio":
            d["den_metric"] = self.den_metric
        if self.kind == "burn_rate":
            d["windows_s"] = [self.short_window_s, self.long_window_s]
        elif self.kind in ("rate", "ratio"):
            d["window_s"] = self.window_s
        if self.help:
            d["help"] = self.help
        return d


def _series_value(value, field):
    """Scalar series as-is; histogram series by ``field`` (sum/count)."""
    if isinstance(value, dict):
        v = value.get(field)
        return None if v is None else float(v)
    try:
        return float(value)
    except (TypeError, ValueError):
        return None


def _select(metrics, metric, labels, field="sum", exclude=None):
    """{series-key: value} of every series of ``metric`` whose labels
    include all ``labels`` pairs. Missing metric -> {} (an interval the
    trackers simply skip). ``exclude`` drops series matching any given
    pair — how synthetic ``origin=probe`` traffic stays out of organic
    SLIs."""
    doc = metrics.get(metric)
    if not isinstance(doc, dict):
        return {}
    out = {}
    for s in doc.get("series", ()):
        slabels = s.get("labels") or {}
        if any(str(slabels.get(k)) != str(v) for k, v in labels.items()):
            continue
        if exclude and any(str(slabels.get(k)) == str(v)
                           for k, v in exclude.items()):
            continue
        v = _series_value(s.get("value"), field)
        if v is None:
            continue
        key = "|".join(f"{k}={v2}" for k, v2 in sorted(slabels.items()))
        out[key] = out.get(key, 0.0) + v
    return out


class _DeltaTrack:
    """Per-series monotone-delta accumulator over sample history.

    The reset/vanish/appear discipline lives here: only a series seen in
    BOTH consecutive samples with a non-decreasing value contributes its
    delta; everything else is a skipped interval for that series."""

    def __init__(self, keep_s=3600.0):
        self._last = {}
        self._acc = 0.0
        self._hist = collections.deque()
        self._keep_s = float(keep_s)

    def sample(self, t, cur):
        delta = 0.0
        for k, v in cur.items():
            prev = self._last.get(k)
            if prev is not None and v >= prev:
                delta += v - prev
        self._last = dict(cur)
        self._acc += delta
        self._hist.append((t, self._acc))
        while len(self._hist) > 2 and self._hist[0][0] < t - self._keep_s:
            self._hist.popleft()
        return delta

    def rate(self, window_s, now):
        """Per-second increase over (up to) the trailing window; None
        until two samples span a positive interval."""
        if len(self._hist) < 2:
            return None
        t_last, acc_last = self._hist[-1]
        base = None
        for t, acc in self._hist:
            if t <= now - window_s:
                base = (t, acc)
            else:
                if base is None:
                    base = (t, acc)
                break
        if base is None:
            base = self._hist[0]
        t0, acc0 = base
        if t_last <= t0:
            return None
        return (acc_last - acc0) / (t_last - t0)

    def delta(self, window_s, now):
        if len(self._hist) < 2:
            return None
        t_last, acc_last = self._hist[-1]
        base = None
        for t, acc in self._hist:
            if t <= now - window_s:
                base = (t, acc)
            else:
                if base is None:
                    base = (t, acc)
                break
        if base is None:
            base = self._hist[0]
        if t_last <= base[0]:
            return None
        return acc_last - base[1]


class _EwmaTrack:
    """Fast-vs-slow EWMA of a histogram's per-interval mean."""

    def __init__(self):
        self._sum = _DeltaTrack()
        self._count = _DeltaTrack()
        self.fast = None
        self.slow = None
        self.intervals = 0

    def sample(self, t, sum_map, count_map, alpha_fast, alpha_slow):
        dsum = self._sum.sample(t, sum_map)
        dcount = self._count.sample(t, count_map)
        if dcount <= 0:
            return
        mean = dsum / dcount
        if self.fast is None:
            self.fast = self.slow = mean
        else:
            self.fast += alpha_fast * (mean - self.fast)
            self.slow += alpha_slow * (mean - self.slow)
        self.intervals += 1

    def drift(self, min_intervals):
        """fast/slow ratio, or None during warmup (or a ~zero slow mean:
        sub-microsecond baselines are noise, not a regression signal)."""
        if self.intervals < min_intervals or not self.slow:
            return None
        if self.slow <= 1e-9:
            return None
        return self.fast / self.slow


class SloEngine:
    """Evaluate a rule set over metric snapshots; hold alert state.

    ``evaluate(metrics=None)`` accepts the local registry (default), a
    registry-snapshot-shaped dict, or a federation doc carrying one
    under ``"metrics"``. Every call appends one sample per rule and
    recomputes the verdicts; call it on whatever cadence you trust
    (``start(interval_s)`` runs a daemon evaluator)."""

    def __init__(self, rules=None, registry=None):
        self._reg = registry or _registry.get_registry()
        self.rules = list(default_rules() if rules is None else rules)
        names = [r.name for r in self.rules]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SLO rule names: {sorted(names)}")
        self._lock = threading.Lock()
        self._tracks = {}
        self._states = {r.name: "ok" for r in self.rules}
        self._since = {}
        self._values = {}
        self._evaluations = 0
        self._last_eval_t = None
        self._thread = None
        self._stop = threading.Event()
        self._m_alerts = self._reg.counter(
            "slo_alerts_total",
            "SLO rule state transitions by rule and entered state "
            "(a clean run counts nothing; recovery counts state=ok)")
        self._m_state = self._reg.gauge(
            "slo_rule_state",
            "current SLO alert level per rule (0 ok, 1 warning, 2 firing)")

    # ---- evaluation ----

    def evaluate(self, metrics=None, now=None):
        """One evaluation pass; returns the status doc (see status())."""
        if now is None:
            now = time.monotonic()
        metrics = _normalize(metrics, self._reg)
        transitions = []
        with self._lock:
            for rule in self.rules:
                level = self._eval_rule(rule, metrics, now)
                if level is None:
                    continue  # insufficient data: hold the current state
                state = _STATES[level]
                prev = self._states[rule.name]
                if state != prev:
                    self._states[rule.name] = state
                    self._since[rule.name] = now
                    transitions.append((rule.name, prev, state))
            self._evaluations += 1
            self._last_eval_t = now
        if self._reg.enabled:
            for name, _prev, state in transitions:
                self._m_alerts.inc(rule=name, state=state)
                self._m_state.set(float(_STATES.index(state)), rule=name)
        return self.status()

    def _eval_rule(self, rule, metrics, now):
        """Predicate -> level (0/1/2), or None for insufficient data."""
        if rule.kind == "threshold":
            cur = _select(metrics, rule.metric, rule.labels, rule.field,
                          rule.exclude_labels)
            if not cur:
                return None
            value = sum(cur.values())
            self._values[rule.name] = value
            return _level(value, rule)
        if rule.kind == "ewma_drift":
            tr = self._tracks.setdefault(rule.name, _EwmaTrack())  # graftlint: disable=R6 -- _eval_rule runs only under evaluate()'s `with self._lock`
            tr.sample(now,
                      _select(metrics, rule.metric, rule.labels, "sum",
                              rule.exclude_labels),
                      _select(metrics, rule.metric, rule.labels, "count",
                              rule.exclude_labels),
                      rule.alpha_fast, rule.alpha_slow)
            value = tr.drift(rule.min_intervals)
            if value is None:
                return None
            self._values[rule.name] = value
            return _level(value, rule)
        if rule.kind == "ratio":
            num = self._tracks.setdefault(  # graftlint: disable=R6 -- _eval_rule runs only under evaluate()'s `with self._lock`
                (rule.name, "num"), _DeltaTrack())
            den = self._tracks.setdefault(  # graftlint: disable=R6 -- _eval_rule runs only under evaluate()'s `with self._lock`
                (rule.name, "den"), _DeltaTrack())
            num.sample(now, _select(metrics, rule.metric, rule.labels,
                                    rule.field, rule.exclude_labels))
            den.sample(now, _select(metrics, rule.den_metric,
                                    rule.den_labels, rule.field,
                                    rule.den_exclude_labels))
            dn = num.delta(rule.window_s, now)
            dd = den.delta(rule.window_s, now)
            if dn is None or dd is None or dd < rule.min_den:
                return None
            value = dn / dd
            self._values[rule.name] = value
            return _level(value, rule)
        # rate / burn_rate share one accumulator
        tr = self._tracks.setdefault(rule.name, _DeltaTrack(  # graftlint: disable=R6 -- _eval_rule runs only under evaluate()'s `with self._lock`
            keep_s=max(2 * rule.long_window_s, 2 * rule.window_s)))
        tr.sample(now, _select(metrics, rule.metric, rule.labels,
                               rule.field, rule.exclude_labels))
        if rule.kind == "rate":
            value = tr.rate(rule.window_s, now)
            if value is None:
                return None
            self._values[rule.name] = value
            return _level(value, rule)
        # burn_rate: the SHORT and LONG windows must both burn
        short = tr.rate(rule.short_window_s, now)
        long_ = tr.rate(rule.long_window_s, now)
        if short is None or long_ is None:
            return None
        self._values[rule.name] = {"short": short, "long": long_}
        lv_s, lv_l = _level(short, rule), _level(long_, rule)
        return min(lv_s, lv_l)

    # ---- queries ----

    def status(self):
        """The status doc: per-rule verdicts + engine bookkeeping."""
        with self._lock:
            rules = []
            for rule in self.rules:
                state = self._states[rule.name]
                d = rule.describe()
                d["state"] = state
                d["value"] = self._values.get(rule.name)
                d["since"] = self._since.get(rule.name)
                rules.append(d)
            return {
                "rules": rules,
                "firing": [r.name for r in self.rules
                           if self._states[r.name] == "firing"],
                "warning": [r.name for r in self.rules
                            if self._states[r.name] == "warning"],
                "evaluations": self._evaluations,
                "last_eval_t": self._last_eval_t,
            }

    def firing(self, tag=None):
        """Names of rules currently firing (optionally tag-filtered) —
        the decision-seam query (snapshot gate, hedging policy)."""
        with self._lock:
            return [r.name for r in self.rules
                    if self._states[r.name] == "firing"
                    and (tag is None or tag in r.tags)]

    def warning(self, tag=None):
        with self._lock:
            return [r.name for r in self.rules
                    if self._states[r.name] == "warning"
                    and (tag is None or tag in r.tags)]

    def state(self, rule_name):
        with self._lock:
            return self._states.get(rule_name)

    def clear(self):
        """Drop histories and verdicts, keep the rule set (tests)."""
        with self._lock:
            self._tracks.clear()
            self._values.clear()
            self._since.clear()
            self._states = {r.name: "ok" for r in self.rules}
            self._evaluations = 0
            self._last_eval_t = None

    # ---- periodic evaluation ----

    def start(self, interval_s=15.0, source=None):
        """Evaluate every ``interval_s`` on a daemon thread. ``source``:
        a callable returning the metrics doc per pass (e.g.
        ``lambda: federate.federate_default()``); None = local registry."""
        if self._thread is not None:
            return self
        self._stop.clear()  # graftlint: disable=R6 -- threading.Event is internally synchronized; self._lock guards rule state, not lifecycle

        def loop():
            while not self._stop.wait(interval_s):
                try:
                    self.evaluate(None if source is None else source())
                except Exception:  # an SLO pass must never kill the host
                    pass

        self._thread = threading.Thread(target=loop, name="slo-engine",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        t, self._thread = self._thread, None
        if t is not None:
            t.join(timeout=5)


def _level(value, rule):
    """Bound comparison -> level index (0 ok / 1 warning / 2 firing)."""
    if rule.op == "gt":
        if value >= rule.fire:
            return 2
        if rule.warn is not None and value >= rule.warn:
            return 1
        return 0
    if value <= rule.fire:
        return 2
    if rule.warn is not None and value <= rule.warn:
        return 1
    return 0


def _normalize(metrics, reg):
    """Local snapshot / snapshot-shaped dict / federation doc -> the
    {name: {kind, series}} form every predicate reads."""
    if metrics is None:
        return reg.snapshot()
    if isinstance(metrics, dict) and "metrics" in metrics \
            and isinstance(metrics["metrics"], dict):
        return metrics["metrics"]
    return metrics


def default_rules():
    """The shipped ruleset over counters that already exist. Thresholds
    are deliberately lenient: a rule earns its place by staying silent
    on healthy runs and firing on the injected storms the tier-1 gate
    drives (shed storm, NaN poison, step-time inflation)."""
    return [
        SloRule(
            "serving_shed_ratio", "ratio", "serving_shed_total",
            den_metric="serving_model_requests_total",
            den_labels={"outcome": "submitted"},
            warn=0.05, fire=0.20, window_s=120.0, min_den=10.0,
            tags=("serving",),
            help="shed requests per submitted request across all models "
                 "(admission control burning capacity, not absorbing it)"),
        SloRule(
            "fleet_failover_rate", "rate", "fleet_failover_total",
            warn=1.0 / 60, fire=3.0 / 60, window_s=300.0,
            tags=("serving", "fleet"),
            help="workers marked dead per second (a respawn loop, not "
                 "the occasional death the supervisor absorbs)"),
        SloRule(
            "continuous_staleness_burn", "burn_rate",
            "continuous_dropped_total", labels={"reason": "stale"},
            warn=0.05, fire=0.2, short_window_s=60.0, long_window_s=600.0,
            tags=("continuous",),
            help="stale-batch drops per second over BOTH windows — the "
                 "ingest pipeline persistently behind the train loop"),
        SloRule(
            "hostfleet_rollback_rate", "rate",
            "hostfleet_rollback_rounds_total",
            warn=0.2 / 60, fire=1.0 / 60, window_s=600.0,
            tags=("hostfleet",),
            help="training rounds lost to generation rollbacks per "
                 "second (elastic re-forms eating the epoch)"),
        SloRule(
            "recompile_storm", "rate", "recompiles_total",
            warn=1.0 / 60, fire=6.0 / 60, window_s=300.0,
            tags=("train", "gate"),
            help="jit cache misses per second after warmup (a shape "
                 "leak recompiling the step in steady state)"),
        SloRule(
            "numerics_anomalies", "rate",
            "train_numerics_anomalies_total",
            fire=1.0 / 600, window_s=600.0,
            tags=("train", "numerics", "gate"),
            help="any watchdog anomaly (NaN/Inf loss or grads) in the "
                 "window fires — a sick run must not publish snapshots"),
        SloRule(
            "step_time_regression", "ewma_drift", "train_step_seconds",
            warn=1.25, fire=1.5, min_intervals=5,
            tags=("train", "regression", "gate"),
            help="fast-vs-slow EWMA of mean step time — creeping step "
                 "latency (fragmentation, background load, thermal)"),
        SloRule(
            "etl_stall_regression", "ewma_drift", "train_etl_seconds",
            warn=1.5, fire=2.0, min_intervals=5,
            tags=("train", "regression"),
            help="fast-vs-slow EWMA of mean host-side batch assembly "
                 "time — the input pipeline decaying under the step"),
        SloRule(
            "probe_failure_ratio", "ratio", "probe_bad_total",
            den_metric="probe_total",
            warn=0.05, fire=0.5, window_s=120.0, min_den=3.0,
            tags=("probe", "fleet", "gate"),
            help="failed synthetic canaries per probe — the fleet judged "
                 "from OUTSIDE: fires on wrong answers, unreachable "
                 "workers, or shed canaries even at zero organic load"),
    ]


# ---- process-default engine ----

_default_engine = None
_default_lock = threading.Lock()


def get_engine():
    """Process-default engine over default_rules(), created on first
    use; registers the flight-dump section so any later dump (SIGTERM
    included) names the rules burning at death."""
    global _default_engine
    with _default_lock:
        if _default_engine is None:
            _default_engine = SloEngine()
            from deeplearning4j_tpu_torch.telemetry import flight as _flight
            _flight.register_dump_section("slo", _dump_section)
        return _default_engine


def reset():
    """Drop the process-default engine (telemetry.reset()); the dump
    section provider stays registered and reads the current default."""
    global _default_engine
    with _default_lock:
        eng, _default_engine = _default_engine, None
    if eng is not None:
        eng.stop()


def _dump_section():
    """Flight-dump payload: which rules were burning (None before the
    first evaluation — nothing to report, nothing to clutter)."""
    with _default_lock:
        eng = _default_engine
    if eng is None or eng._evaluations == 0:
        return None
    st = eng.status()
    return {"firing": st["firing"], "warning": st["warning"],
            "evaluations": st["evaluations"],
            "rules": [{"name": r["name"], "state": r["state"],
                       "value": r["value"]}
                      for r in st["rules"] if r["state"] != "ok"]}


def alerts(tag=None):
    """``{"firing": [...], "warning": [...]}`` from the process-default
    engine — empty lists when no engine exists yet (the inert-seam
    contract: consumers embed this without waking the SLO plane up)."""
    with _default_lock:
        eng = _default_engine
    if eng is None:
        return {"firing": [], "warning": []}
    return {"firing": eng.firing(tag=tag), "warning": eng.warning(tag=tag)}


def firing_gate_rules():
    """Names of firing rules tagged ``gate`` — the ContinuousTrainer
    snapshot-gate query. Deliberately side-effect-light: no engine is
    created (and nothing evaluates) unless one already exists, so the
    seam is inert until something turns the SLO plane on."""
    with _default_lock:
        eng = _default_engine
    if eng is None:
        return []
    return eng.firing(tag="gate")

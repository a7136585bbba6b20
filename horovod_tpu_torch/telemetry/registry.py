"""Process-local metric registry: counters, gauges, bounded-bucket
histograms with labeled families (a framework-free copy of
``horovod_tpu/telemetry/registry.py``).

The reference credits its introspection tooling with finding the perf
problems that motivated fusion and autotuning (arXiv:1802.05799 §5);
characterization studies of distributed-training stacks show that
without per-collective latency/byte accounting regressions hide inside
end-to-end step time (arXiv:1810.11112).  This registry is the one
place every layer reports to: the engine dispatch loop, the compiled
path's program cache, the autotuner, the elastic driver and the stall
inspector all update families here, and the exporter
(:mod:`.exporter`) renders one snapshot as Prometheus text or JSON.

Design constraints:

* **cheap from the dispatch loop** — a child update is one dict lookup
  plus a lock-free-in-practice float add (one small lock per family;
  the engine caches child handles so the hot path never re-resolves
  labels);
* **bounded** — histograms use a fixed bucket ladder (no per-value
  allocation), families are keyed by small label tuples;
* **mergeable** — :func:`merge_snapshots` implements the job-wide
  aggregation contract (counters sum, gauges report per-worker
  max/min, histograms merge bucket-wise) used by the coordinator's
  ``/metrics``.
"""

import logging
import re
import threading

__all__ = [
    "MetricRegistry", "registry", "install_registry", "fresh_registry",
    "merge_snapshots", "DEFAULT_LATENCY_BUCKETS",
    "REQUEST_LATENCY_BUCKETS",
]

logger = logging.getLogger("horovod_tpu_torch.telemetry")

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")

#: Default histogram ladder for latencies in seconds: 100us .. 60s —
#: tuned for engine cycle / negotiation times.
DEFAULT_LATENCY_BUCKETS = (
    0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025,
    0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
)

#: Ladder for ms-scale request latencies (seconds): the serving tier's
#: SLO histograms live between 0.5 ms and 10 s, where the engine-cycle
#: ladder above has almost no resolution.  Families pick their bounds
#: at registration time (``histogram(..., buckets=...)``); the bounds
#: become part of the family's identity — re-registering with
#: different bounds raises, and :func:`merge_snapshots` refuses to
#: silently co-bucket heterogeneous ladders.
REQUEST_LATENCY_BUCKETS = (
    0.0005, 0.001, 0.002, 0.003, 0.005, 0.0075, 0.01, 0.015, 0.025,
    0.05, 0.075, 0.1, 0.15, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


def _label_key(labelnames, labels):
    try:
        return tuple(str(labels[n]) for n in labelnames)
    except KeyError as exc:
        raise ValueError(
            f"metric expects labels {labelnames}, got "
            f"{sorted(labels)}") from exc


class _Counter:
    """Monotonic counter child."""

    __slots__ = ("_lock", "value")

    def __init__(self, lock):
        self._lock = lock
        self.value = 0.0

    def inc(self, amount=1.0):
        if amount < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self.value += amount


class _Gauge:
    """Set/inc/dec gauge child."""

    __slots__ = ("_lock", "value")

    def __init__(self, lock):
        self._lock = lock
        self.value = 0.0

    def set(self, value):
        with self._lock:
            self.value = float(value)

    def inc(self, amount=1.0):
        with self._lock:
            self.value += amount

    def dec(self, amount=1.0):
        with self._lock:
            self.value -= amount


class _Histogram:
    """Fixed-ladder histogram child (reference prometheus semantics:
    cumulative ``le`` buckets + ``_sum`` + ``_count``).  Counts are
    stored per-bucket (non-cumulative) and cumulated at render time."""

    __slots__ = ("_lock", "bounds", "counts", "sum", "count")

    def __init__(self, lock, bounds):
        self._lock = lock
        self.bounds = bounds
        self.counts = [0] * (len(bounds) + 1)   # +1: the +Inf bucket
        self.sum = 0.0
        self.count = 0

    def observe(self, value):
        value = float(value)
        # linear scan is fine: ladders are short and the loop body is
        # one compare (bisect would allocate via the attribute lookup)
        i = 0
        bounds = self.bounds
        n = len(bounds)
        while i < n and value > bounds[i]:
            i += 1
        with self._lock:
            self.counts[i] += 1
            self.sum += value
            self.count += 1


class _Family:
    """One named metric family: a set of children keyed by label
    values.  ``labels(**kw)`` resolves (and caches) a child; families
    declared with no label names proxy the update methods of their
    single anonymous child."""

    def __init__(self, name, mtype, help_text, labelnames,
                 buckets=None):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        self.name = name
        self.type = mtype
        self.help = help_text
        self.labelnames = tuple(labelnames)
        self.buckets = tuple(buckets) if buckets is not None else None
        self._lock = threading.Lock()
        self._children = {}
        if not self.labelnames:
            self._anon = self._make()
            self._children[()] = self._anon
        else:
            self._anon = None

    def _make(self):
        if self.type == "counter":
            return _Counter(self._lock)
        if self.type == "gauge":
            return _Gauge(self._lock)
        return _Histogram(self._lock, self.buckets)

    def labels(self, **labels):
        key = _label_key(self.labelnames, labels)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.get(key)
                if child is None:
                    child = self._make()
                    self._children[key] = child
        return child

    # -- anonymous-child proxies (families without labels) ------------------

    def inc(self, amount=1.0):
        self._children[()].inc(amount)

    def set(self, value):
        self._children[()].set(value)

    def dec(self, amount=1.0):
        self._children[()].dec(amount)

    def observe(self, value):
        self._children[()].observe(value)

    # -- reading -------------------------------------------------------------

    @staticmethod
    def _read(child):
        """One number per child: value for counters/gauges, the
        observation count for histograms (so ``counter_total`` over
        any catalogue name answers sensibly instead of raising)."""
        return child.count if isinstance(child, _Histogram) \
            else child.value

    def total(self):
        """Sum over all children: values (counters/gauges) or
        observation counts (histograms)."""
        with self._lock:
            return sum(self._read(c) for c in self._children.values())

    def value(self, **labels):
        key = _label_key(self.labelnames, labels)
        child = self._children.get(key)
        return 0.0 if child is None else self._read(child)

    def as_dict(self):
        """{label-value tuple (or single value): number};
        single-label families key by the bare value."""
        with self._lock:
            items = list(self._children.items())
        if len(self.labelnames) == 1:
            return {k[0]: self._read(c) for k, c in items}
        return {k: self._read(c) for k, c in items}

    def remove(self, **labels):
        key = _label_key(self.labelnames, labels)
        with self._lock:
            self._children.pop(key, None)

    def clear(self):
        with self._lock:
            self._children.clear()
            if self._anon is not None:
                self._anon = self._make()
                self._children[()] = self._anon

    def snapshot(self):
        with self._lock:
            items = list(self._children.items())
        samples = []
        for key, child in items:
            labels = dict(zip(self.labelnames, key))
            if self.type == "histogram":
                samples.append({"labels": labels,
                                "counts": list(child.counts),
                                "sum": child.sum,
                                "count": child.count})
            else:
                samples.append({"labels": labels, "value": child.value})
        out = {"type": self.type, "help": self.help,
               "labelnames": list(self.labelnames), "samples": samples}
        if self.buckets is not None:
            out["buckets"] = list(self.buckets)
        return out


class MetricRegistry:
    """One process-local registry; family getters are idempotent (the
    engine, the compiled path and the autotuner can each declare the
    family they update without coordinating creation order)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families = {}

    def _family(self, name, mtype, help_text, labelnames, buckets=None):
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = _Family(name, mtype, help_text, labelnames,
                              buckets=buckets)
                self._families[name] = fam
            elif fam.type != mtype:
                raise ValueError(
                    f"metric {name} already registered as {fam.type}, "
                    f"not {mtype}")
            elif mtype == "histogram" and buckets is not None \
                    and tuple(buckets) != fam.buckets:
                # bucket bounds are part of a histogram family's
                # identity: two declaring sites disagreeing would have
                # the second site's observations silently mis-bucketed
                # into the first site's ladder
                raise ValueError(
                    f"histogram {name} already registered with buckets "
                    f"{fam.buckets}, not {tuple(buckets)}")
            return fam

    def counter(self, name, help_text="", labelnames=()):
        return self._family(name, "counter", help_text, labelnames)

    def gauge(self, name, help_text="", labelnames=()):
        return self._family(name, "gauge", help_text, labelnames)

    def histogram(self, name, help_text="", labelnames=(),
                  buckets=DEFAULT_LATENCY_BUCKETS):
        return self._family(name, "histogram", help_text, labelnames,
                            buckets=buckets)

    def get(self, name):
        return self._families.get(name)

    def snapshot(self):
        """JSON-able view of every family — the exposition and
        aggregation input format."""
        with self._lock:
            fams = list(self._families.items())
        return {name: fam.snapshot() for name, fam in fams}


# -- process-current registry -------------------------------------------------
#
# One registry is "current" per process.  init() installs a fresh one
# per engine lifecycle (an elastic re-init starts clean counters);
# everything else resolves it through registry() at update time.

_REGISTRY_LOCK = threading.Lock()
_current = MetricRegistry()


def registry() -> MetricRegistry:
    """The process-current registry."""
    return _current


def install_registry(reg: MetricRegistry) -> MetricRegistry:
    global _current
    with _REGISTRY_LOCK:
        _current = reg
    return reg


def fresh_registry() -> MetricRegistry:
    """Install and return a brand-new current registry (engine init)."""
    return install_registry(MetricRegistry())


# -- job-wide aggregation -----------------------------------------------------

def merge_snapshots(snapshots):
    """Merge per-worker registry snapshots into one job-wide snapshot
    (the coordinator's ``/metrics`` semantics):

    * **counters** sum across workers;
    * **gauges** report the per-worker extremes — each label set gains
      an ``agg`` label with ``max`` and ``min`` samples (a queue-depth
      or stalled-tensor gauge answers "is ANY worker unhealthy", so
      the extremes are the aggregation, not the mean);
    * **histograms** merge bucket-wise.  Ladders are per-family now
      (``histogram(..., buckets=...)``), so two workers disagreeing on
      a family's bounds — a version skew, or two subsystems fighting
      over one name — can no longer be co-bucketed honestly: the
      mismatched worker's samples are DROPPED from the aggregate with
      a warning naming the family, instead of silently mis-bucketing
      its counts into the wrong bounds.
    """
    merged = {}
    mismatched = set()
    for snap in snapshots:
        if not isinstance(snap, dict):
            continue
        for name, fam in snap.items():
            out = merged.get(name)
            if out is None:
                out = merged[name] = {
                    "type": fam.get("type", "counter"),
                    "help": fam.get("help", ""),
                    "labelnames": list(fam.get("labelnames", [])),
                    "_acc": {},
                }
                if "buckets" in fam:
                    out["buckets"] = list(fam["buckets"])
            elif out["type"] == "histogram" and \
                    list(fam.get("buckets", [])) != \
                    out.get("buckets", []):
                if name not in mismatched:
                    mismatched.add(name)
                    logger.warning(
                        "merge_snapshots: histogram %s has "
                        "heterogeneous bucket bounds across workers "
                        "(%s vs %s); dropping the mismatched "
                        "worker's samples from the aggregate", name,
                        fam.get("buckets"), out.get("buckets"))
                continue
            acc = out["_acc"]
            for sample in fam.get("samples", []):
                key = tuple(sorted(sample.get("labels", {}).items()))
                if out["type"] == "histogram":
                    cur = acc.get(key)
                    counts = sample.get("counts", [])
                    if cur is None:
                        acc[key] = {
                            "labels": dict(sample.get("labels", {})),
                            "counts": list(counts),
                            "sum": float(sample.get("sum", 0.0)),
                            "count": int(sample.get("count", 0))}
                    elif len(cur["counts"]) == len(counts):
                        cur["counts"] = [a + b for a, b in
                                         zip(cur["counts"], counts)]
                        cur["sum"] += float(sample.get("sum", 0.0))
                        cur["count"] += int(sample.get("count", 0))
                    elif name not in mismatched:
                        # same bounds list but ragged counts: a
                        # half-written push — still refuse silently
                        mismatched.add(name)
                        logger.warning(
                            "merge_snapshots: histogram %s sample has "
                            "%d buckets where the family has %d; "
                            "dropping it from the aggregate", name,
                            len(counts), len(cur["counts"]))
                else:
                    val = float(sample.get("value", 0.0))
                    cur = acc.get(key)
                    if cur is None:
                        acc[key] = {
                            "labels": dict(sample.get("labels", {})),
                            "sum": val, "max": val, "min": val}
                    else:
                        cur["sum"] += val
                        cur["max"] = max(cur["max"], val)
                        cur["min"] = min(cur["min"], val)
    result = {}
    for name, fam in merged.items():
        samples = []
        if fam["type"] == "histogram":
            samples = list(fam["_acc"].values())
        elif fam["type"] == "gauge":
            labelnames = fam["labelnames"]
            if "agg" not in labelnames:
                labelnames = labelnames + ["agg"]
            for cur in fam["_acc"].values():
                for agg in ("max", "min"):
                    samples.append({
                        "labels": {**cur["labels"], "agg": agg},
                        "value": cur[agg]})
            fam = dict(fam, labelnames=labelnames)
        else:
            for cur in fam["_acc"].values():
                samples.append({"labels": cur["labels"],
                                "value": cur["sum"]})
        out = {"type": fam["type"], "help": fam["help"],
               "labelnames": fam["labelnames"], "samples": samples}
        if "buckets" in fam:
            out["buckets"] = fam["buckets"]
        result[name] = out
    return result

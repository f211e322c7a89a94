"""Metric registry of the serving stack: counters, gauges and streaming
log-bucket histograms, with Prometheus text exposition and a JSONL sink —
the JAX package's ``repro.serve.metrics``, kept as the port's own copy
(pure Python; the arithmetic is the reference's, so bucket edges, sums and
quantiles come out bit for bit alike).

* **Streaming histograms, no per-sample storage.** ``Histogram`` keeps a
  fixed geometric bucket ladder (``lo * growth**i``): every ``observe`` is
  a bisect over the precomputed edges and one integer increment, and
  quantiles (p50/p90/p99 TTFT, TPOT, E2E latency) come from log-linear
  interpolation inside the covering bucket, clamped to the observed
  min/max.
* **Prometheus text exposition** (``MetricRegistry.prometheus_text``):
  ``# HELP`` / ``# TYPE`` and cumulative ``_bucket{le=...}`` lines;
  ``parse_prometheus_text`` validates one without a Prometheus install.
* **JSONL sink** (``MetricRegistry.write_jsonl``): one JSON snapshot per
  call appended to a file.

Metric names follow Prometheus conventions (``snake_case``, ``_total`` on
counters, a base-unit suffix such as ``_seconds``).
"""
from __future__ import annotations

import bisect
import json
import math
import re
from typing import Dict, List, Optional, Tuple

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")


def _check_name(name: str) -> str:
    if not _NAME_RE.match(name):
        raise ValueError(f"invalid metric name {name!r}")
    return name


class Counter:
    """Monotonic counter. ``inc`` only; use a Gauge for set-to-value."""

    __slots__ = ("name", "help", "value")
    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = _check_name(name)
        self.help = help
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"{self.name}: counters only go up (inc {n})")
        self.value += n

    def merge(self, other: "Counter") -> None:
        """Fold another replica's counter in (sum — counters are
        extensive)."""
        self.value += other.value


class Gauge:
    """Set-to-current-value metric (pool occupancy, live error bounds)."""

    __slots__ = ("name", "help", "value")
    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        self.name = _check_name(name)
        self.help = help
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def max(self, v: float) -> None:
        """Running-maximum update (peak trackers, live error bounds)."""
        self.value = max(self.value, float(v))

    def merge(self, other: "Gauge") -> None:
        """Fold another replica's gauge in. Gauges are point-in-time
        values with no universally correct cross-replica reduction; max is
        the conservative choice for everything this stack exports (peaks,
        occupancy high-water, error bounds)."""
        self.value = max(self.value, other.value)


class Histogram:
    """Streaming histogram over fixed geometric buckets.

    Bucket ``i`` covers ``(lo*growth**(i-1), lo*growth**i]``; bucket 0 is
    ``(0, lo]`` and one overflow bucket catches everything above the top
    edge. Defaults span 1 microsecond to ~50 minutes at ~25% bucket width
    — latency-shaped. Quantile error is bounded by the bucket width
    (log-linear interpolation inside the covering bucket), which is plenty
    for p50/p99 reporting; exact extremes are kept in ``min``/``max``.
    """

    __slots__ = ("name", "help", "lo", "growth", "counts", "count", "sum",
                 "min", "max", "_edges")
    kind = "histogram"

    def __init__(self, name: str, help: str = "", lo: float = 1e-6,
                 growth: float = 1.25, n_buckets: int = 98):
        if lo <= 0 or growth <= 1 or n_buckets < 2:
            raise ValueError("need lo > 0, growth > 1, n_buckets >= 2")
        self.name = _check_name(name)
        self.help = help
        self.lo = lo
        self.growth = growth
        # counts[0..n-1] are the ladder, counts[n] is the +Inf overflow
        self.counts = [0] * (n_buckets + 1)
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        # precomputed upper edges of the ladder buckets: observe() is on
        # the serving hot path (several per decode step), and a C-level
        # bisect over these beats float log math — and lands samples on
        # the EXACT same boundaries upper_edge()/quantile() report
        self._edges = [lo * growth ** i for i in range(n_buckets)]

    def _bucket_index(self, x: float) -> int:
        # first bucket whose upper edge covers x; len(_edges) == overflow
        return bisect.bisect_left(self._edges, x)

    def upper_edge(self, i: int) -> float:
        """Upper bound of bucket ``i`` (inf for the overflow bucket)."""
        if i >= len(self.counts) - 1:
            return math.inf
        return self.lo * self.growth ** i

    def observe(self, x: float) -> None:
        x = float(x)
        if not math.isfinite(x) or x < 0:
            return                      # clock glitches must not poison p99
        self.counts[self._bucket_index(x)] += 1
        self.count += 1
        self.sum += x
        self.min = min(self.min, x)
        self.max = max(self.max, x)

    def quantile(self, q: float) -> float:
        """q in [0, 1]; 0.0 when empty. Log-linear interpolation inside
        the covering bucket, clamped to the observed min/max so tiny
        samples don't report values outside what was actually seen."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
        if self.count == 0:
            return 0.0
        rank = q * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            if seen + c >= rank:
                hi = self.upper_edge(i)
                lo = self.lo * self.growth ** (i - 1) if i > 0 else 0.0
                if not math.isfinite(hi):
                    return self.max
                frac = (rank - seen) / c
                est = lo + (hi - lo) * frac
                return min(max(est, self.min), self.max)
            seen += c
        return self.max

    def merge(self, other: "Histogram") -> None:
        """Fold another histogram with the IDENTICAL bucket ladder into
        this one — the per-replica aggregation primitive. Exact: geometric
        ladders are closed under elementwise count addition, so quantiles
        of the merge are as accurate as if every sample had been observed
        here (min/max stay exact too). Mismatched ladders raise — resample
        semantics across different ladders would be silently lossy."""
        if (other.lo, other.growth, len(other.counts)) != \
                (self.lo, self.growth, len(self.counts)):
            raise ValueError(
                f"{self.name}: cannot merge mismatched bucket ladders "
                f"(lo/growth/n {self.lo}/{self.growth}/{len(self.counts)} "
                f"vs {other.lo}/{other.growth}/{len(other.counts)})")
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.count += other.count
        self.sum += other.sum
        self.min = min(self.min, other.min)
        self.max = max(self.max, other.max)

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0


class MetricRegistry:
    """Flat namespace of metrics; get-or-create accessors so publishing
    sites never need to coordinate registration order."""

    def __init__(self):
        self._metrics: Dict[str, object] = {}

    def _get(self, cls, name: str, help: str, **kw):
        m = self._metrics.get(name)
        if m is None:
            m = cls(name, help, **kw)
            self._metrics[name] = m
        elif not isinstance(m, cls):
            raise ValueError(f"metric {name!r} already registered as "
                             f"{type(m).__name__}, requested {cls.__name__}")
        return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "", **kw) -> Histogram:
        return self._get(Histogram, name, help, **kw)

    def __iter__(self):
        return iter(sorted(self._metrics.values(), key=lambda m: m.name))

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def get(self, name: str):
        return self._metrics.get(name)

    def reset(self) -> None:
        """Drop every registered metric (coherent-reset semantics: a
        fresh registry, not zeroed husks — callers re-create lazily)."""
        self._metrics.clear()

    def collect(self, *registries: "MetricRegistry",
                prefix: str = "") -> "MetricRegistry":
        """Aggregate same-named metrics from per-replica registries into
        this one (groundwork for the multi-replica front-end): counters
        and histograms merge additively, gauges take the max, and
        ``prefix`` restricts which metric names are collected (e.g.
        ``prefix="serve_"``). Metrics absent here are created with the
        source's ladder/help; kind mismatches raise. Returns self so
        ``MetricRegistry().collect(*replicas)`` reads naturally."""
        for reg in registries:
            for m in reg:
                if prefix and not m.name.startswith(prefix):
                    continue
                if isinstance(m, Histogram):
                    mine = self._get(Histogram, m.name, m.help, lo=m.lo,
                                     growth=m.growth,
                                     n_buckets=len(m.counts) - 1)
                else:
                    mine = self._get(type(m), m.name, m.help)
                mine.merge(m)
        return self

    # -- export -----------------------------------------------------------

    def prometheus_text(self) -> str:
        """Standard Prometheus text exposition (version 0.0.4)."""
        out: List[str] = []
        for m in self:
            if m.help:
                out.append(f"# HELP {m.name} {m.help}")
            out.append(f"# TYPE {m.name} {m.kind}")
            if isinstance(m, Histogram):
                cum = 0
                for i, c in enumerate(m.counts):
                    cum += c
                    edge = m.upper_edge(i)
                    le = "+Inf" if math.isinf(edge) else repr(edge)
                    out.append(f'{m.name}_bucket{{le="{le}"}} {cum}')
                out.append(f"{m.name}_sum {m.sum!r}")
                out.append(f"{m.name}_count {m.count}")
            else:
                out.append(f"{m.name} {m.value!r}")
        return "\n".join(out) + "\n"

    def snapshot(self) -> Dict[str, object]:
        """JSON-able view: scalars verbatim, histograms as summary stats
        plus the standard quantiles."""
        snap: Dict[str, object] = {}
        for m in self:
            if isinstance(m, Histogram):
                snap[m.name] = {
                    "count": m.count,
                    "sum": round(m.sum, 9),
                    "mean": round(m.mean, 9),
                    "min": round(m.min, 9) if m.count else 0.0,
                    "max": round(m.max, 9) if m.count else 0.0,
                    "p50": round(m.quantile(0.50), 9),
                    "p90": round(m.quantile(0.90), 9),
                    "p99": round(m.quantile(0.99), 9),
                }
            else:
                snap[m.name] = m.value
        return snap

    def write_jsonl(self, path: str,
                    extra: Optional[Dict[str, object]] = None) -> None:
        """Append one snapshot as a single JSON line (the JSONL sink)."""
        rec = dict(extra or {})
        rec["metrics"] = self.snapshot()
        with open(path, "a") as f:
            json.dump(rec, f, sort_keys=True)
            f.write("\n")


# ---------------------------------------------------------------------------
# Minimal exposition parser (tests + CI smoke validate without Prometheus)
# ---------------------------------------------------------------------------

_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?\s+(?P<value>\S+)$")


def parse_prometheus_text(text: str) -> Dict[str, Dict]:
    """Parse a text exposition into {family: {"type": ..., "samples":
    [(name, labels, value)]}}. Raises ValueError on malformed lines —
    the CI smoke's "does the exposition parse" check. Validates histogram
    bucket monotonicity and the +Inf bucket == _count invariant."""
    families: Dict[str, Dict] = {}
    types: Dict[str, str] = {}
    for ln, line in enumerate(text.splitlines(), 1):
        line = line.strip()
        if not line:
            continue
        if line.startswith("# HELP "):
            continue
        if line.startswith("# TYPE "):
            parts = line.split(None, 3)
            if len(parts) != 4:
                raise ValueError(f"line {ln}: malformed TYPE: {line!r}")
            types[parts[2]] = parts[3]
            families.setdefault(parts[2], {"type": parts[3], "samples": []})
            continue
        if line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            raise ValueError(f"line {ln}: malformed sample: {line!r}")
        name = m.group("name")
        labels: Dict[str, str] = {}
        if m.group("labels"):
            for item in m.group("labels").split(","):
                if not item:
                    continue
                k, _, v = item.partition("=")
                if not v.startswith('"') or not v.endswith('"'):
                    raise ValueError(f"line {ln}: unquoted label: {line!r}")
                labels[k.strip()] = v[1:-1]
        try:
            value = float(m.group("value"))
        except ValueError:
            raise ValueError(f"line {ln}: bad value: {line!r}")
        family = name
        for suffix in ("_bucket", "_sum", "_count"):
            base = name[:-len(suffix)] if name.endswith(suffix) else None
            if base and types.get(base) == "histogram":
                family = base
                break
        families.setdefault(family, {"type": types.get(family, "untyped"),
                                     "samples": []})
        families[family]["samples"].append((name, labels, value))

    for fam, info in families.items():
        if info["type"] != "histogram":
            continue
        buckets: List[Tuple[float, float]] = []
        count = None
        for name, labels, value in info["samples"]:
            if name == f"{fam}_bucket":
                le = labels.get("le")
                buckets.append((math.inf if le == "+Inf" else float(le),
                                value))
            elif name == f"{fam}_count":
                count = value
        buckets.sort(key=lambda e: e[0])
        cum = [v for _, v in buckets]
        if cum != sorted(cum):
            raise ValueError(f"{fam}: bucket counts not cumulative")
        if buckets and count is not None and buckets[-1][1] != count:
            raise ValueError(f"{fam}: +Inf bucket != _count")
    return families

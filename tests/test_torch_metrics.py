"""The port's metrics plane (``metis_tpu_torch/obs/metrics.py``) against
the reference's (``metis_tpu/obs/metrics.py``).

The reference's ``tests/test_metrics.py`` runs on the port unchanged
(histogram quantiles against a numpy oracle, merge algebra, concurrency,
counter/gauge/rate semantics, the Prometheus render/parse round trip and
the reference's exposition lint), and the two packages are held to each
other: the same instrument calls render the same exposition bytes, each
package parses the other's scrape to the same families, the bucket
bounds and the metric catalog (names, kinds, help, label sets) are equal.
"""
import random
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

import metis_tpu.obs.metrics as jmetrics
import metis_tpu_torch.obs as tobs
import metis_tpu_torch.obs.metrics as tmetrics
from metis_tpu_torch.obs.metrics import (
    DEFAULT_BOUNDS,
    Histogram,
    MetricsRegistry,
    NULL_METRICS,
    RateMeter,
    parse_exposition,
    quantile_from_buckets,
)

# one bucket spans a factor of 10**(1/20); a quantile estimate landing in
# the right bucket is off by at most that ratio plus the nearest-rank
# discretization at small n
_BUCKET_RATIO = 10.0 ** (1.0 / 20.0)


def _oracle(samples, q):
    """Nearest-rank percentile, matching Histogram.quantile's definition."""
    return float(np.quantile(np.asarray(samples), q,
                             method="inverted_cdf"))


class TestHistogramOracle:
    @pytest.mark.parametrize("dist", ["uniform", "lognormal", "bimodal"])
    @pytest.mark.parametrize("q", [0.5, 0.95, 0.99])
    def test_quantiles_within_bucket_resolution(self, dist, q):
        rng = random.Random(hash((dist, q)) & 0xFFFF)
        if dist == "uniform":
            samples = [rng.uniform(0.1, 50.0) for _ in range(5000)]
        elif dist == "lognormal":
            samples = [rng.lognormvariate(0.0, 2.0) for _ in range(5000)]
        else:
            samples = ([rng.gauss(1.0, 0.05) for _ in range(2500)]
                       + [rng.gauss(100.0, 5.0) for _ in range(2500)])
            samples = [max(s, 1e-3) for s in samples]
        h = Histogram()
        for s in samples:
            h.observe(s)
        est = h.quantile(q)
        exact = _oracle(samples, q)
        assert est == pytest.approx(exact, rel=_BUCKET_RATIO - 1.0 + 0.02)

    def test_small_n_exact_extremes(self):
        h = Histogram()
        for v in [3.0, 7.0, 11.0]:
            h.observe(v)
        # estimates are clamped to the observed range
        assert h.quantile(0.0) >= 3.0 - 1e-9
        assert h.quantile(1.0) <= 11.0 + 1e-9
        assert h.count == 3
        assert h.sum == pytest.approx(21.0)
        assert h.min == 3.0 and h.max == 11.0

    def test_empty_quantile_none(self):
        assert Histogram().quantile(0.5) is None

    def test_out_of_range_observations_land_in_edge_buckets(self):
        h = Histogram()
        h.observe(0.0)        # below the lowest bound
        h.observe(1e12)       # above the highest
        assert h.count == 2
        assert h.quantile(0.5) is not None


class TestHistogramMerge:
    def _rand_hist(self, seed, n=400):
        rng = random.Random(seed)
        h = Histogram()
        for _ in range(n):
            h.observe(rng.lognormvariate(1.0, 1.5))
        return h

    def _merged(self, *hists):
        out = Histogram()
        for h in hists:
            out.merge(h)
        return out

    def _state(self, h):
        return (h.count, h.sum, h.min, h.max, h.to_dict()["counts"])

    def test_commutative(self):
        a, b = self._rand_hist(1), self._rand_hist(2)
        assert self._state(self._merged(a, b)) \
            == self._state(self._merged(b, a))

    def test_associative(self):
        a, b, c = (self._rand_hist(s) for s in (3, 4, 5))
        ab_c = self._merged(self._merged(a, b), c)
        a_bc = self._merged(a, self._merged(b, c))
        assert self._state(ab_c) == self._state(a_bc)

    def test_merge_equals_pooled_observation(self):
        rng = random.Random(6)
        samples = [rng.lognormvariate(0.5, 1.0) for _ in range(1000)]
        pooled = Histogram()
        for s in samples:
            pooled.observe(s)
        shards = [Histogram() for _ in range(4)]
        for i, s in enumerate(samples):
            shards[i % 4].observe(s)
        merged = self._merged(*shards)
        assert merged.count == pooled.count
        assert merged.sum == pytest.approx(pooled.sum)  # fp ordering
        assert (merged.min, merged.max) == (pooled.min, pooled.max)
        assert merged.to_dict()["counts"] == pooled.to_dict()["counts"]

    def test_dict_round_trip(self):
        a = self._rand_hist(7)
        b = Histogram()
        b.merge_dict(a.to_dict())
        assert self._state(b) == self._state(a)
        # merging the dict again doubles, like a second worker's report
        b.merge_dict(a.to_dict())
        assert b.count == 2 * a.count
        assert b.sum == pytest.approx(2 * a.sum)

    def test_merge_bounds_mismatch_raises(self):
        a = Histogram()
        b = Histogram(bounds=(1.0, 10.0, 100.0))
        with pytest.raises(ValueError):
            a.merge(b)


class TestConcurrency:
    def test_concurrent_observe_loses_nothing(self):
        h = Histogram()
        reg = MetricsRegistry()
        counter = reg.counter("metis_serve_requests_total", endpoint="t")
        per_thread, threads = 2000, 8

        def work(seed):
            rng = random.Random(seed)
            for _ in range(per_thread):
                h.observe(rng.uniform(0.01, 100.0))
                counter.inc()

        ts = [threading.Thread(target=work, args=(i,)) for i in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert h.count == per_thread * threads
        assert counter.value == per_thread * threads
        # bucket mass must reconcile with the count
        assert sum(h.to_dict()["counts"].values()) == h.count

    def test_concurrent_registry_access_single_instrument(self):
        reg = MetricsRegistry()
        seen = []

        def grab():
            seen.append(reg.counter("metis_serve_cache_hits_total"))

        ts = [threading.Thread(target=grab) for _ in range(16)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert all(c is seen[0] for c in seen)


class TestInstruments:
    def test_counter_monotonic(self):
        reg = MetricsRegistry()
        c = reg.counter("metis_serve_requests_total", endpoint="plan")
        c.inc()
        c.inc(2.5)
        assert c.value == pytest.approx(3.5)
        with pytest.raises(ValueError):
            c.inc(-1)

    def test_gauge_set_inc_dec(self):
        g = MetricsRegistry().gauge("metis_serve_inflight_requests")
        g.set(5)
        g.inc()
        g.dec(2)
        assert g.value == pytest.approx(4.0)

    def test_rate_meter_window(self):
        r = RateMeter(window_s=60.0)
        for _ in range(30):
            r.mark()
        assert r.rate() > 0.0
        assert RateMeter().rate() == 0.0

    def test_kind_conflict_raises(self):
        reg = MetricsRegistry()
        reg.counter("metis_serve_cache_hits_total")
        with pytest.raises(ValueError):
            reg.gauge("metis_serve_cache_hits_total")

    def test_label_values_distinguish_series(self):
        reg = MetricsRegistry()
        a = reg.counter("metis_serve_requests_total", endpoint="plan")
        b = reg.counter("metis_serve_requests_total", endpoint="stats")
        a.inc(3)
        b.inc(1)
        assert a.value == 3 and b.value == 1

    def test_invalid_names_rejected(self):
        reg = MetricsRegistry()
        with pytest.raises(ValueError):
            reg.counter("bad name")
        with pytest.raises(ValueError):
            reg.counter("ok_name", **{"bad-label": "x"})


class TestNullRegistry:
    def test_disabled_registry_is_free_and_silent(self):
        reg = MetricsRegistry(enabled=False)
        c = reg.counter("metis_serve_requests_total", endpoint="plan")
        g = reg.gauge("metis_serve_inflight_requests")
        h = reg.histogram("metis_serve_request_latency_ms", endpoint="plan")
        r = reg.rate("metis_serve_qps")
        c.inc()
        g.set(7)
        g.inc()
        g.dec()
        h.observe(1.0)
        r.mark()
        assert h.quantile(0.5) is None
        assert r.rate() == 0.0
        assert c.value == 0.0 and g.value == 0.0
        assert reg.render().strip() == ""

    def test_null_metrics_shared_no_op(self):
        c = NULL_METRICS.counter("anything_goes_here")
        c.inc(1e9)
        assert c.value == 0.0


class TestRenderParse:
    def _populated(self):
        reg = MetricsRegistry()
        reg.counter("metis_serve_requests_total", endpoint="plan").inc(5)
        reg.counter("metis_serve_requests_total", endpoint="stats").inc(2)
        reg.gauge("metis_serve_inflight_requests").set(1)
        h = reg.histogram("metis_serve_request_latency_ms", endpoint="plan")
        for v in (0.5, 1.5, 2.5, 40.0):
            h.observe(v)
        reg.rate("metis_serve_qps").mark(10)
        return reg

    def test_round_trip(self):
        reg = self._populated()
        families = parse_exposition(reg.render())
        reqs = families["metis_serve_requests_total"]
        assert reqs["type"] == "counter"
        by_ep = {dict(labels)["endpoint"]: v
                 for _, labels, v in reqs["samples"]}
        assert by_ep == {"plan": 5.0, "stats": 2.0}
        hist = families["metis_serve_request_latency_ms"]
        assert hist["type"] == "histogram"
        counts = [v for name, labels, v in hist["samples"]
                  if name.endswith("_count")]
        assert counts == [4.0]
        # +Inf bucket equals _count
        inf_bucket = [v for name, labels, v in hist["samples"]
                      if name.endswith("_bucket")
                      and dict(labels).get("le") == "+Inf"]
        assert inf_bucket == [4.0]

    def test_render_passes_exposition_lint(self):
        sys.path.insert(0, str(Path(__file__).resolve().parent.parent
                               / "tools"))
        import check_metrics_names
        assert check_metrics_names.validate_exposition(
            self._populated().render()) == []

    def test_quantile_from_buckets_matches_histogram(self):
        h = Histogram()
        rng = random.Random(11)
        samples = [rng.lognormvariate(0.0, 1.0) for _ in range(2000)]
        for s in samples:
            h.observe(s)
        est = quantile_from_buckets(h.cumulative_buckets(), 0.95)
        # bucket-only estimate lacks the min/max clamp but must still be
        # within one bucket of the oracle
        assert est == pytest.approx(_oracle(samples, 0.95),
                                    rel=_BUCKET_RATIO - 1.0 + 0.02)

    def test_label_escaping(self):
        reg = MetricsRegistry()
        reg.counter("metis_fleet_preemptions_total",
                    tenant='we"ird\\ten\nant').inc()
        families = parse_exposition(reg.render())
        _, labels, v = families["metis_fleet_preemptions_total"]["samples"][0]
        assert dict(labels)["tenant"] == 'we"ird\\ten\nant'
        assert v == 1.0

    def test_parse_rejects_garbage(self):
        with pytest.raises(ValueError):
            parse_exposition("this is { not exposition\n")


class TestRegistryMerge:
    def test_cross_registry_merge(self):
        a, b = MetricsRegistry(), MetricsRegistry()
        a.counter("metis_serve_requests_total", endpoint="plan").inc(3)
        b.counter("metis_serve_requests_total", endpoint="plan").inc(4)
        b.histogram("metis_serve_request_latency_ms",
                    endpoint="plan").observe(1.0)
        a.merge(b)
        assert a.counter("metis_serve_requests_total",
                         endpoint="plan").value == 7.0
        assert a.histogram("metis_serve_request_latency_ms",
                           endpoint="plan").count == 1

    def test_default_bounds_shape(self):
        # 20 per decade over 1e-6..1e9: (9 - -6) * 20 + 1 bounds
        assert len(DEFAULT_BOUNDS) == 15 * 20 + 1
        assert DEFAULT_BOUNDS[0] == pytest.approx(1e-6)
        assert DEFAULT_BOUNDS[-1] == pytest.approx(1e9)


# ---------------------------------------------------------------------------
# the port against the reference
# ---------------------------------------------------------------------------


def _drive(mod):
    """One script of instrument calls on a fresh registry of ``mod``."""
    reg = mod.MetricsRegistry()
    reg.counter("metis_serve_requests_total", endpoint="plan").inc(5)
    reg.counter("metis_serve_requests_total", endpoint="stats").inc(2.5)
    reg.gauge("metis_serve_inflight_requests").set(3)
    reg.gauge("metis_fleet_tenant_devices", tenant='we"ird').set(8)
    h = reg.histogram("metis_serve_request_latency_ms", endpoint="plan")
    rng = random.Random(7)
    for _ in range(500):
        h.observe(rng.lognormvariate(0.0, 2.0))
    h.observe(0.0)
    h.observe(1e12)
    reg.histogram("metis_search_duration_seconds",
                  kind="training").observe(0.25)
    return reg


def test_same_calls_render_the_same_exposition():
    assert _drive(tmetrics).render() == _drive(jmetrics).render()


def test_each_package_parses_the_others_scrape():
    jtext, ttext = _drive(jmetrics).render(), _drive(tmetrics).render()
    assert tmetrics.parse_exposition(jtext) == jmetrics.parse_exposition(jtext)
    assert jmetrics.parse_exposition(ttext) == tmetrics.parse_exposition(ttext)


def test_histogram_state_and_quantiles_equal():
    rng = random.Random(3)
    samples = [rng.expovariate(0.1) for _ in range(1000)]
    hj, ht = jmetrics.Histogram(), tmetrics.Histogram()
    for s in samples:
        hj.observe(s)
        ht.observe(s)
    assert ht.to_dict() == hj.to_dict()
    for q in (0.0, 0.5, 0.9, 0.99, 1.0):
        assert ht.quantile(q) == hj.quantile(q)
    buckets = ht.cumulative_buckets()
    assert buckets == hj.cumulative_buckets()
    assert (tmetrics.quantile_from_buckets(buckets, 0.95)
            == jmetrics.quantile_from_buckets(buckets, 0.95))
    # a dict of one package merges into the other's histogram
    merged = tmetrics.Histogram()
    merged.merge_dict(hj.to_dict())
    assert merged.to_dict() == hj.to_dict()


def test_default_bounds_equal_the_reference():
    assert tmetrics.DEFAULT_BOUNDS == jmetrics.DEFAULT_BOUNDS


def test_metric_catalog_equal_the_reference():
    """Names, kinds, help texts and label sets: what ``top`` and any
    scraper read."""
    assert tmetrics.METRIC_CATALOG == jmetrics.METRIC_CATALOG
    assert list(tmetrics.METRIC_CATALOG) == list(jmetrics.METRIC_CATALOG)


def test_obs_package_exports_the_registry():
    assert tobs.MetricsRegistry is tmetrics.MetricsRegistry
    assert tobs.NULL_METRICS is tmetrics.NULL_METRICS
    assert not tobs.NULL_METRICS.enabled

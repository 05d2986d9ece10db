"""The port's serving planner (``metis_tpu_torch.inference``) against the
JAX package's (``metis_tpu.inference``): the counterpart of
``tests/test_inference.py`` without the plan daemon and the traffic replay,
which are not ported yet.

Both packages read the parity fixtures of ``metis_tpu.testing`` (the plain
one and the one with decode tables).  The serving search's dump must be
byte-identical to the reference's, with the counts and headline numbers
of the frozen goldens (``tools/search_inference_golden.json``,
``tools/search_inference_decode_golden.json``); the workload model and the
KV memory model are checked case by case on both packages.
"""
import dataclasses
import hashlib
import json
from pathlib import Path

import pytest

from metis_tpu.inference import planner as jplanner
from metis_tpu.inference import workload as jworkload
from metis_tpu.testing import (
    PARITY_GBS,
    PARITY_INFERENCE,
    PARITY_INFERENCE_PREFIX,
    PARITY_MAX_BS,
    PARITY_MAX_TP,
    write_decode_parity_fixture,
    write_parity_fixture,
)
from metis_tpu_torch.balance.stage_perf import max_kv_concurrency
from metis_tpu_torch.cluster.spec import ClusterSpec
from metis_tpu_torch.core.config import ModelSpec, SearchConfig
from metis_tpu_torch.core.errors import KvCacheOomError
from metis_tpu_torch.core.events import EventLog, read_events
from metis_tpu_torch.cost.estimator import (
    kv_bytes_per_token,
    kv_stage_bytes,
    paged_kv_seq_bytes,
    paged_tokens,
    shared_prefix_stage_bytes,
)
from metis_tpu_torch.inference import planner as tplanner
from metis_tpu_torch.inference import workload as tworkload
from metis_tpu_torch.inference import (
    InferenceWorkload,
    dump_inference_plans,
    plan_inference,
    workload_from_dict,
)
from metis_tpu_torch.profiles.store import ProfileStore

TOOLS = Path(__file__).resolve().parents[1] / "tools"
GOLDENS = {"parity": "search_inference_golden.json",
           "decode": "search_inference_decode_golden.json"}
WORKLOADS = {"parity": PARITY_INFERENCE, "decode": PARITY_INFERENCE_PREFIX}


def _model(**over) -> ModelSpec:
    """The parity fixture's model (``metis_tpu.profiles.tiny_test_model``)."""
    return ModelSpec(**{**dict(name="gpt-test", num_layers=10,
                               hidden_size=4096, sequence_length=1024,
                               vocab_size=51200, num_heads=32), **over})


def _config(**over) -> SearchConfig:
    return SearchConfig(gbs=PARITY_GBS, max_profiled_tp=PARITY_MAX_TP,
                        max_profiled_bs=PARITY_MAX_BS, **over)


def _workload(**over) -> InferenceWorkload:
    return InferenceWorkload(**{**PARITY_INFERENCE, **over})


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    root = tmp_path_factory.mktemp("inference")
    write_parity_fixture(root / "parity")
    write_decode_parity_fixture(root / "decode")
    return root


def _inputs(fixture_dir):
    return (ClusterSpec.from_files(fixture_dir / "hostfile",
                                   fixture_dir / "clusterfile.json"),
            ProfileStore.from_dir(fixture_dir / "profiles"))


def _reference_dump(fixture_dir, spec: dict, **config) -> str:
    from metis_tpu.cluster import ClusterSpec as JClusterSpec
    from metis_tpu.core.config import SearchConfig as JSearchConfig
    from metis_tpu.profiles import ProfileStore as JProfileStore, tiny_test_model

    cluster = JClusterSpec.from_files(fixture_dir / "hostfile",
                                      fixture_dir / "clusterfile.json")
    store = JProfileStore.from_dir(fixture_dir / "profiles")
    wl = jworkload.InferenceWorkload(**spec)
    cfg = JSearchConfig(gbs=PARITY_GBS, max_profiled_tp=PARITY_MAX_TP,
                        max_profiled_bs=PARITY_MAX_BS, **config)
    return jplanner.dump_inference_plans(
        jplanner.plan_inference(cluster, store, tiny_test_model(), cfg, wl),
        wl)


@pytest.fixture(scope="module")
def searched(fixtures):
    """Each fixture's port search, its dump and the reference's dump."""
    out = {}
    for name, spec in WORKLOADS.items():
        cluster, store = _inputs(fixtures / name)
        wl = InferenceWorkload(**spec)
        result = plan_inference(cluster, store, _model(), _config(), wl)
        out[name] = (result, wl, dump_inference_plans(result, wl),
                     _reference_dump(fixtures / name, spec))
    return out


# ---------------------------------------------------------------------------
# the search: bytes, goldens, ranking
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(GOLDENS))
def test_dump_is_byte_identical_to_the_reference(searched, name):
    _, _, dump, reference = searched[name]
    assert dump == reference


@pytest.mark.parametrize("name", sorted(GOLDENS))
def test_dump_matches_the_frozen_golden(searched, name):
    """The golden's counts and headline numbers, and the sha256 of the
    reference's dump of this run: the reference's own dumps no longer
    reproduce the goldens' frozen sha256 on this numpy (its regression
    gate reports that drift), so the frozen digest is not the yardstick."""
    result, _, dump, reference = searched[name]
    golden = json.loads((TOOLS / GOLDENS[name]).read_text())
    assert hashlib.sha256(dump.encode()).hexdigest() \
        == hashlib.sha256(reference.encode()).hexdigest()
    assert result.num_costed == golden["num_costed"] == 1436
    assert result.num_splits == golden["num_splits"] == 7
    best = result.best
    assert round(best.cost.ttft_p99_ms, 4) == golden["best_ttft_p99_ms"]
    assert round(best.cost.tpot_p99_ms, 4) == golden["best_tpot_p99_ms"]
    assert round(best.cost.throughput_rps, 4) == golden["best_max_rps"]
    assert best.decode.decode_source == golden.get("best_decode_source", "")


def test_best_plan_meets_both_slos(searched):
    result, wl, _, _ = searched["parity"]
    best = result.best
    assert best is not None and best.cost.slo_ok
    assert best.cost.ttft_p99_ms <= wl.slo_ttft_p99_ms
    assert best.cost.tpot_p99_ms <= wl.slo_tpot_p99_ms
    assert best.cost.throughput_rps >= wl.arrival_rate_rps


@pytest.mark.parametrize("name", sorted(GOLDENS))
def test_pools_disjoint_and_components_sum(searched, name):
    result = searched[name][0]
    for p in result.plans:
        assert p.prefill.num_devices >= 1 and p.decode.num_devices >= 1
        assert p.prefill.num_devices + p.decode.num_devices <= 16
        c = p.cost
        assert c.ttft_p99_ms == pytest.approx(c.ttft_component_sum_ms, abs=1e-9)
        assert c.tpot_p99_ms == pytest.approx(c.tpot_component_sum_ms, abs=1e-9)


def test_ranking_prefers_feasible_then_throughput(searched):
    result = searched["parity"][0]
    flags = [p.cost.slo_ok for p in result.plans]
    assert flags == sorted(flags, reverse=True)
    for a, b in zip(result.plans, result.plans[1:]):
        if a.cost.slo_ok == b.cost.slo_ok:
            assert a.cost.throughput_rps >= b.cost.throughput_rps


def test_deterministic_dump_and_fingerprints(fixtures, searched):
    result, wl, dump, _ = searched["parity"]
    cluster, store = _inputs(fixtures / "parity")
    again = plan_inference(cluster, store, _model(), _config(), wl)
    assert dump_inference_plans(again, wl) == dump
    for ours, theirs in zip(result.plans, json.loads(searched["parity"][3])["plans"]):
        assert tplanner.fingerprint_inference_plan(ours) == hashlib.sha1(
            json.dumps({k: theirs[k] for k in ("prefill", "decode", "cost")},
                       sort_keys=True, separators=(",", ":")).encode()
        ).hexdigest()[:12]
    assert tplanner.fingerprint_inference_plan(None) is None


def test_top_k_keeps_the_first_plans(fixtures, searched):
    result, wl, _, _ = searched["parity"]
    cluster, store = _inputs(fixtures / "parity")
    top = plan_inference(cluster, store, _model(), _config(), wl, top_k=2)
    assert [p.to_json_dict() for p in top.plans] \
        == [p.to_json_dict() for p in result.plans[:2]]


def test_planner_survives_oom_topology(fixtures):
    # every device shrunk to 32 MB: the weights alone overflow, every decode
    # candidate prunes, and the search reports that rather than batch-0 plans
    cluster, store = _inputs(fixtures / "parity")
    tiny = ClusterSpec(nodes=cluster.nodes, devices={
        name: dataclasses.replace(d, memory_gb=1 / 32)
        for name, d in cluster.devices.items()})
    result = plan_inference(tiny, store, _model(), _config(), _workload())
    assert result.plans == () and result.num_pruned > 0


def test_emits_valid_inference_plan_events(fixtures, tmp_path):
    from tools.check_events_schema import validate_events

    cluster, store = _inputs(fixtures / "parity")
    path = tmp_path / "inf_events.jsonl"
    log = EventLog(path)
    # starved SLOs: the best plan violates, so slo_violation fires too
    plan_inference(cluster, store, _model(), _config(),
                   _workload(slo_tpot_p99_ms=0.001), events=log)
    log.close()
    events = read_events(path)
    names = {e["event"] for e in events}
    assert {"inference_plan", "slo_violation"} <= names
    assert validate_events(events) == []


# ---------------------------------------------------------------------------
# measured decode tables -> TPOT pricing
# ---------------------------------------------------------------------------


def test_measured_table_changes_tpot_and_tags_the_source(searched):
    derived, wl = searched["parity"][0], searched["parity"][1]
    measured = searched["decode"][0]
    assert derived.best.decode.decode_source == ""
    assert "decode_source" not in dump_inference_plans(derived, wl)
    assert measured.best.decode.decode_source == "measured"
    assert '"decode_source": "measured"' in searched["decode"][2]
    assert measured.best.cost.tpot_p99_ms \
        != pytest.approx(derived.best.cost.tpot_p99_ms)


def test_partial_coverage_falls_back_to_derived(fixtures):
    # T4 entries stripped of their decode tables: a decode pool touching a
    # T4 falls back whole-candidate, all-A100 pools keep the measurement
    cluster, store = _inputs(fixtures / "decode")
    entries = {k: (dataclasses.replace(p, decode_layer_times_ms=None,
                                       decode_context_len=0)
                   if k[0] == "T4" else p)
               for k, p in ((k, store.get(*k)) for k in store.configs())}
    partial = ProfileStore(entries, store.model, store.type_meta)
    assert partial.has_decode()
    result = plan_inference(cluster, partial, _model(), _config(), _workload())
    sources = {p.decode.decode_source for p in result.plans}
    assert "derived" in sources and sources <= {"measured", "derived"}
    for p in result.plans:
        assert p.decode.decode_source == (
            "derived" if "T4" in p.decode.node_counts else "measured")


def test_decode_rates_match_the_reference(fixtures):
    """The per-stage primitives on the decode fixture, both packages."""
    from metis_tpu.profiles import ProfileStore as JProfileStore, tiny_test_model

    store = _inputs(fixtures / "decode")[1]
    jstore = JProfileStore.from_dir(fixtures / "decode" / "profiles")
    jmodel = tiny_test_model()
    for t, tp, lo, hi in (("A100", 1, 0, 10), ("T4", 2, 1, 6), ("A100", 4, 5, 10)):
        assert tworkload.largest_profiled_bs(store, t, tp, 12) \
            == jworkload.largest_profiled_bs(jstore, t, tp, 12) == 8
        assert tworkload.largest_decode_bs(store, t, tp, 12) \
            == jworkload.largest_decode_bs(jstore, t, tp, 12)
        assert tworkload.measured_decode_stage_ms(store, t, tp, lo, hi, 3, 16) \
            == jworkload.measured_decode_stage_ms(jstore, t, tp, lo, hi, 3, 16)
        assert tworkload.decode_compute_stage_ms(
            store, _model(), t, tp, lo, hi, 5, 16) \
            == jworkload.decode_compute_stage_ms(
                jstore, jmodel, t, tp, lo, hi, 5, 16)
        assert tworkload.prefill_stage_ms(store, _model(), t, tp, lo, hi, 700) \
            == jworkload.prefill_stage_ms(jstore, jmodel, t, tp, lo, hi, 700)
    assert tworkload.largest_decode_bs(store, "H100", 1, 16) == 0
    assert tworkload.measured_decode_stage_ms(store, "H100", 1, 0, 2, 1, 16) is None
    assert tworkload.hbm_read_ms(3.35e9, 3350.0) == 1.0
    curve = tworkload.throughput_curve(lambda b: 10.0 + b, [1, 4, 0])
    assert curve == jworkload.throughput_curve(lambda b: 10.0 + b, [1, 4, 0])


# ---------------------------------------------------------------------------
# queueing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("c,load", [(1, 0.5), (4, 3.2), (8, 0.0), (3, 3.0),
                                    (16, 12.7)])
def test_erlang_c_and_queue_waits_match_the_reference(c, load):
    assert tplanner.erlang_c(c, load) == jplanner.erlang_c(c, load)
    for rps, service in ((4.0, 20.0), (150.0, 22.4), (1.0, 1e4)):
        assert tplanner.queue_wait_p99_ms(rps, c, service) \
            == jplanner.queue_wait_p99_ms(rps, c, service)
    assert tplanner.max_rps_under_wait(c, 20.0, 1800.0) \
        == jplanner.max_rps_under_wait(c, 20.0, 1800.0)
    assert tplanner.max_rps_under_wait(c, 20.0, -1.0) == 0.0


def test_pool_splits_and_split_cluster(fixtures):
    from metis_tpu.cluster import ClusterSpec as JClusterSpec

    cluster = _inputs(fixtures / "parity")[0]
    jcluster = JClusterSpec.from_files(fixtures / "parity" / "hostfile",
                                       fixtures / "parity" / "clusterfile.json")
    splits = list(tplanner.pool_splits(cluster))
    assert splits == list(jplanner.pool_splits(jcluster))
    assert len(splits) == 7
    for counts in splits:
        pre, dec = tplanner.split_cluster(cluster, counts)
        jpre, jdec = jplanner.split_cluster(jcluster, counts)
        for ours, theirs in ((pre, jpre), (dec, jdec)):
            assert [(n.device_type, n.num_devices) for n in ours.nodes] \
                == [(n.device_type, n.num_devices) for n in theirs.nodes]
            assert sorted(ours.devices) == sorted(theirs.devices)
        assert pre.total_devices + dec.total_devices == 16


# ---------------------------------------------------------------------------
# workload model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bad", [
    dict(arrival_rate_rps=0.0), dict(output_len=0), dict(prompt_len=0),
    dict(slo_tpot_p99_ms=-1.0), dict(slo_ttft_p99_ms=0.0),
    dict(prompt_len_p99=10), dict(output_len_p99=5), dict(kv_dtype_bytes=0),
    dict(prefix_share_frac=1.5), dict(prefix_share_frac=-0.1),
    dict(prefix_len=-1), dict(page_tokens=-1),
])
def test_workload_rejects_what_the_reference_rejects(bad):
    spec = {**PARITY_INFERENCE, **bad}
    with pytest.raises(ValueError) as theirs:
        jworkload.InferenceWorkload(**spec)
    with pytest.raises(ValueError) as ours:
        InferenceWorkload(**spec)
    assert str(ours.value) == str(theirs.value)


def test_from_dict_rejects_unknown_keys():
    with pytest.raises(ValueError, match="slo_ttft_ms"):
        workload_from_dict({**PARITY_INFERENCE, "slo_ttft_ms": 5.0})
    assert workload_from_dict(dict(PARITY_INFERENCE)) == _workload()


def test_tail_lengths_and_serialization():
    wl = _workload()
    assert wl.tail_prompt_len == wl.prompt_len
    assert wl.max_context_len == wl.prompt_len + wl.output_len
    assert _workload(prompt_len_p99=1024, output_len_p99=256).max_context_len \
        == 1280
    assert _workload(prefix_share_frac=0.5, prefix_len=10_000).shared_prefix_len \
        == wl.tail_prompt_len
    for spec in (PARITY_INFERENCE, PARITY_INFERENCE_PREFIX):
        assert InferenceWorkload(**spec).to_json_dict() \
            == jworkload.InferenceWorkload(**spec).to_json_dict()
    plain = wl.to_json_dict()
    assert not {"prefix_share_frac", "prefix_len", "page_tokens"} & set(plain)


# ---------------------------------------------------------------------------
# KV-cache memory model
# ---------------------------------------------------------------------------


def test_kv_bytes_per_token_scales():
    m = _model()
    full = kv_bytes_per_token(m)
    assert kv_bytes_per_token(dataclasses.replace(m, num_kv_heads=8)) \
        == full * 8 / m.num_heads
    assert kv_bytes_per_token(dataclasses.replace(m, num_kv_heads=1)) \
        == full / m.num_heads
    assert kv_bytes_per_token(m, kv_dtype_bytes=1) == full / 2
    assert kv_bytes_per_token(m, tp=4) == full / 4


def test_embed_and_head_pseudo_layers_cache_nothing():
    m = _model()
    assert kv_stage_bytes(m, batch=4, context_len=640, start=0, end=1) == 0
    assert kv_stage_bytes(m, batch=4, context_len=640, start=m.num_layers - 1,
                          end=m.num_layers) == 0
    assert kv_stage_bytes(m, batch=1, context_len=1, start=0,
                          end=m.num_layers) \
        == kv_bytes_per_token(m) * (m.num_layers - 2)


def test_max_kv_concurrency_cases():
    mb = 1024 * 1024
    # a KV-free stage must not clamp the pool's concurrency to zero
    assert max_kv_concurrency(100.0, 1024.0, 0.0) == 1 << 30
    for weights in (10.0 * mb, 10.0 * mb + 1):
        with pytest.raises(KvCacheOomError):
            max_kv_concurrency(10.0, weights, 1.0)
    assert max_kv_concurrency(10.0, 2.0 * mb, 1.0 * mb) == 8
    # shared prefix pages are a one-off charge on the pool
    assert max_kv_concurrency(10.0, 2.0 * mb, 1.0 * mb,
                              shared_bytes=3.0 * mb) == 5
    assert max_kv_concurrency(10.0, 2.0 * mb, 1.0 * mb,
                              shared_bytes=9.0 * mb) == 0
    with pytest.raises(KvCacheOomError):
        max_kv_concurrency(1.0, 2.0 * mb, 1.0 * mb, shared_bytes=0.0)


def test_paged_tokens_rounds_up_to_page():
    assert paged_tokens(33, 16) == 48
    assert paged_tokens(32, 16) == 32
    assert paged_tokens(0, 16) == 0
    assert paged_tokens(640, 0) == 640
    assert paged_tokens(5, 4096) == 4096


def test_sharing_off_full_and_partial():
    m = _model()
    plain = kv_stage_bytes(m, 1, 640, 0, m.num_layers)
    assert paged_kv_seq_bytes(m, 640, 0, m.num_layers) == plain
    assert paged_kv_seq_bytes(m, 640, 0, m.num_layers, prefix_len=256,
                              prefix_share_frac=0.0) == plain
    assert shared_prefix_stage_bytes(m, 256, 640, 0, m.num_layers) == 0.0
    assert paged_kv_seq_bytes(m, 640, 0, m.num_layers, prefix_len=256,
                              prefix_share_frac=1.0) \
        == kv_stage_bytes(m, 1, 640 - 256, 0, m.num_layers)
    assert paged_kv_seq_bytes(m, 640, 0, m.num_layers, prefix_len=10_000,
                              prefix_share_frac=1.0) == 0.0
    assert paged_kv_seq_bytes(m, 5, 0, m.num_layers, page_tokens=4096) \
        == kv_stage_bytes(m, 1, 4096, 0, m.num_layers)
    full = kv_stage_bytes(m, 1, paged_tokens(640, 16), 0, m.num_layers)
    uniq = kv_stage_bytes(m, 1, paged_tokens(640 - 256, 16), 0, m.num_layers)
    got = paged_kv_seq_bytes(m, 640, 0, m.num_layers, page_tokens=16,
                             prefix_len=256, prefix_share_frac=0.6)
    assert got == pytest.approx(0.6 * uniq + 0.4 * full)
    assert uniq < got < full


def test_gqa_int8_and_sharing_compose():
    m = _model()
    gqa = dataclasses.replace(m, num_kv_heads=8)
    kw = dict(page_tokens=16, prefix_len=256, prefix_share_frac=0.5)
    base = paged_kv_seq_bytes(m, 640, 0, m.num_layers, 2, 1, **kw)
    assert paged_kv_seq_bytes(gqa, 640, 0, m.num_layers, 2, 1, **kw) \
        == pytest.approx(base * 8 / m.num_heads)
    assert paged_kv_seq_bytes(m, 640, 0, m.num_layers, 1, 1, **kw) \
        == pytest.approx(base / 2)
    skw = dict(page_tokens=16, prefix_share_frac=0.5)
    shared = shared_prefix_stage_bytes(m, 256, 640, 0, m.num_layers, 2, 1, **skw)
    assert shared_prefix_stage_bytes(gqa, 256, 640, 0, m.num_layers, 2, 1,
                                     **skw) \
        == pytest.approx(shared * 8 / m.num_heads)


# ---------------------------------------------------------------------------
# query fingerprints with workloads
# ---------------------------------------------------------------------------


def _fp(workload=None):
    from metis_tpu_torch.obs.ledger import query_fingerprint

    cluster = ClusterSpec.of(("A100", 1, 4), ("T4", 1, 4))
    return query_fingerprint(_model(), cluster, _config(), workload=workload)


def _reference_fp(spec=None):
    from metis_tpu.cluster import ClusterSpec as JClusterSpec
    from metis_tpu.core.config import SearchConfig as JSearchConfig
    from metis_tpu.obs.ledger import query_fingerprint
    from metis_tpu.profiles import tiny_test_model

    cluster = JClusterSpec.of(("A100", 1, 4), ("T4", 1, 4))
    cfg = JSearchConfig(gbs=PARITY_GBS, max_profiled_tp=PARITY_MAX_TP,
                        max_profiled_bs=PARITY_MAX_BS)
    wl = None if spec is None else jworkload.InferenceWorkload(**spec)
    return query_fingerprint(tiny_test_model(), cluster, cfg, workload=wl)


def test_training_never_aliases_inference():
    assert _fp() != _fp(_workload())
    assert _fp(_workload()) == _fp(_workload())
    assert _fp() == _reference_fp()
    assert _fp(_workload()) == _reference_fp(PARITY_INFERENCE)


@pytest.mark.parametrize("flip", [
    dict(arrival_rate_rps=5.0), dict(prompt_len=513), dict(output_len=129),
    dict(slo_ttft_p99_ms=1000.0), dict(slo_tpot_p99_ms=50.0),
    dict(prompt_len_p99=1024), dict(output_len_p99=256), dict(kv_dtype_bytes=1),
    dict(prefix_share_frac=0.5), dict(prefix_len=128), dict(page_tokens=16),
])
def test_every_workload_field_flips_the_key(flip):
    assert _fp(_workload()) != _fp(_workload(**flip))
    assert _fp(_workload(**flip)) == _reference_fp({**PARITY_INFERENCE, **flip})

"""The port's cost model, balancers, search enumeration and observability
modules against the JAX package's, one module at a time, on the same inputs.

These modules are host-side numpy and stdlib in both packages, so every
result must be equal, not close.  The whole planner is held end to end in
``tests/test_torch_planner.py``.
"""
import dataclasses
import io
import json

import numpy as np
import pytest

import metis_tpu.balance.data as jdata
import metis_tpu.balance.layers as jlayers
import metis_tpu.balance.stage_perf as jstage
import metis_tpu.cluster.spec as jcluster
import metis_tpu.core.config as jconfig
import metis_tpu.core.events as jevents
import metis_tpu.core.trace as jtrace
import metis_tpu.core.types as jtypes
import metis_tpu.cost.context_parallel as jcp
import metis_tpu.cost.expert_parallel as jep
import metis_tpu.cost.ici as jici
import metis_tpu.cost.schedule as jsched
import metis_tpu.cost.uncertainty as junc
import metis_tpu.cost.volume as jvolume
import metis_tpu.cost.zero as jzero
import metis_tpu.obs.ledger as jledger
import metis_tpu.planner.api as japi
import metis_tpu.profiles.store as jstore
import metis_tpu.search.device_groups as jdg
import metis_tpu.search.inter_stage as jinter
import metis_tpu.search.uniform as juniform
from metis_tpu.profiles import tiny_test_model
from metis_tpu.testing import PARITY_GBS, write_parity_fixture
import metis_tpu_torch.balance.data as tdata
import metis_tpu_torch.balance.layers as tlayers
import metis_tpu_torch.balance.stage_perf as tstage
import metis_tpu_torch.cluster.spec as tcluster
import metis_tpu_torch.core.config as tconfig
import metis_tpu_torch.core.events as tevents
import metis_tpu_torch.core.trace as ttrace
import metis_tpu_torch.core.types as ttypes
import metis_tpu_torch.cost.context_parallel as tcp
import metis_tpu_torch.cost.expert_parallel as tep
import metis_tpu_torch.cost.schedule as tsched
import metis_tpu_torch.cost.uncertainty as tunc
import metis_tpu_torch.cost.volume as tvolume
import metis_tpu_torch.cost.zero as tzero
import metis_tpu_torch.obs.ledger as tledger
import metis_tpu_torch.planner.api as tapi
import metis_tpu_torch.profiles.store as tstore
import metis_tpu_torch.search.device_groups as tdg
import metis_tpu_torch.search.inter_stage as tinter
import metis_tpu_torch.search.uniform as tuniform

MOE = dict(name="moe", num_layers=6, hidden_size=256, sequence_length=512,
           vocab_size=1000, num_heads=8, num_experts=8, expert_top_k=2)


@pytest.fixture(scope="module")
def parity_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("cost_parity")
    write_parity_fixture(root)
    return root


def _cluster(mod, d):
    return mod.ClusterSpec.from_files(d / "hostfile", d / "clusterfile.json")


def test_cluster_from_files(parity_dir):
    j, t = _cluster(jcluster, parity_dir), _cluster(tcluster, parity_dir)
    assert [dataclasses.asdict(n) for n in t.nodes] == [
        dataclasses.asdict(n) for n in j.nodes]
    assert {k: dataclasses.asdict(v) for k, v in t.devices.items()} == {
        k: dataclasses.asdict(v) for k, v in j.devices.items()}
    assert t.device_types == j.device_types
    assert t.total_devices == j.total_devices == 16


@pytest.mark.parametrize("n,group,bw", [
    (1024.0, 1, 50.0), (4e6, 2, 50.0), (4e6, 8, 10.0), (3.3e7, 16, 450.0),
])
def test_all_to_all_copy_matches_the_torus_model(n, group, bw):
    for wrap in (True, False):
        assert tep.all_to_all_ms(n, group, bw, 0.01, wrap) == (
            jici.all_to_all_ms(n, group, bw, 0.01, wrap))


@pytest.mark.parametrize("mbs,ep,layers,bw", [(1, 2, 4, 50.0), (4, 8, 4, 10.0),
                                             (2, 4, 0, 50.0), (2, 1, 4, 50.0)])
def test_expert_parallel(mbs, ep, layers, bw):
    jm, tm = jconfig.ModelSpec(**MOE), tconfig.ModelSpec(**MOE)
    assert tep.ep_a2a_ms(tm, mbs, ep, layers, bw) == jep.ep_a2a_ms(
        jm, mbs, ep, layers, bw)
    assert tep.a2a_bytes_per_layer(tm, mbs, ep) == jep.a2a_bytes_per_layer(
        jm, mbs, ep)
    assert tep.expert_param_fraction(tm) == jep.expert_param_fraction(jm)
    assert tep.ep_candidates(8, 8) == jep.ep_candidates(8, 8)


@pytest.mark.parametrize("mode", ["ring", "a2a"])
def test_context_parallel(mode):
    jm = jconfig.ModelSpec(**dict(MOE, num_experts=0, expert_top_k=1))
    tm = tconfig.ModelSpec(**dict(MOE, num_experts=0, expert_top_k=1))
    for mbs, cp, tp in ((1, 2, 1), (2, 4, 2), (4, 2, 4)):
        assert tcp.cp_comm_ms(tm, mbs, cp, tp, 4, 50.0, mode=mode) == (
            jcp.cp_comm_ms(jm, mbs, cp, tp, 4, 50.0, mode=mode))
    assert tcp.attention_layer_range(tm, 0, 6) == jcp.attention_layer_range(jm, 0, 6)
    assert tcp.cp_candidates(8, 512) == jcp.cp_candidates(8, 512)


def test_zero():
    params = (1000, 5000, 5000, 800)
    for stage in (0, 1, 2, 3):
        assert tzero.zero_dp_factor(stage) == jzero.zero_dp_factor(stage)
        for ranks, tp in ((1, 1), (4, 1), (8, 2)):
            assert tzero.zero_static_reduction_mb(params, stage, ranks, tp) == (
                jzero.zero_static_reduction_mb(params, stage, ranks, tp))
    assert tzero.zero_candidates(True) == jzero.zero_candidates(True)


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b", "interleaved"])
def test_schedule(schedule):
    lens = [3.0, 2.5, 4.25, 1.0]
    for batches, vs in ((4, 1), (8, 2), (16, 2)):
        valid = tsched.schedule_valid(schedule, 4, batches, vs, 8)
        assert valid == jsched.schedule_valid(schedule, 4, batches, vs, 8)
        if valid:
            assert tsched.schedule_execution_ms(schedule, lens, batches, vs) == (
                jsched.schedule_execution_ms(schedule, lens, batches, vs))
    assert tsched.REMAT_FWD_FRACTION == jsched.REMAT_FWD_FRACTION


def test_volume(parity_dir):
    jp = jstore.ProfileStore.from_dir(parity_dir / "profiles")
    tp_ = tstore.ProfileStore.from_dir(parity_dir / "profiles")
    m = dataclasses.asdict(tiny_test_model())
    jv = jvolume.TransformerVolume(jconfig.ModelSpec(**m),
                                   jp.model.params_per_layer_bytes)
    tv = tvolume.TransformerVolume(tconfig.ModelSpec(**m),
                                   tp_.model.params_per_layer_bytes)
    for tp in (1, 2, 4):
        assert tv.parameter_bytes_per_layer(tp) == jv.parameter_bytes_per_layer(tp)
        for boundary in (1, 5, 9):
            for elements in (True, False):
                assert tv.boundary_activation(boundary, 4, tp, elements) == (
                    jv.boundary_activation(boundary, 4, tp, elements))


def test_data_balancer(parity_dir):
    jb = jdata.DataBalancer(jstore.ProfileStore.from_dir(parity_dir / "profiles"))
    tb = tdata.DataBalancer(tstore.ProfileStore.from_dir(parity_dir / "profiles"))
    for types, dp, tp, bs in ((["A100", "T4"], 2, 1, 16),
                              (["T4", "T4", "A100", "A100"], 2, 2, 8),
                              (["A100"] * 4, 4, 1, 32), (["T4", "A100"], 1, 4, 4)):
        assert tb.partition(types, dp, tp, bs) == jb.partition(types, dp, tp, bs)
    for types, tp, bs in ((("A100",), 1, 13), (("T4",), 2, 6)):
        assert tb.replica_exec_time(types[0], tp, bs) == (
            jb.replica_exec_time(types[0], tp, bs))
    assert tdata.power_of_two_chunks(13) == jdata.power_of_two_chunks(13)
    assert tdata.proportional_split([3.0, 1.0, 2.0], 17) == (
        jdata.proportional_split([3.0, 1.0, 2.0], 17))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_layer_partition_dp(seed):
    """The port runs only the numpy DP; the reference's C++ DP (when built)
    and its numpy DP give the same boundaries."""
    rng = np.random.default_rng(seed)
    weights = rng.uniform(0.1, 2.0, 12).tolist()
    perf = rng.uniform(0.5, 3.0, 4).tolist()
    caps = rng.uniform(0.4, 1.0, (4, 13, 13)) > 0.3
    for feasible in (None, caps):
        got = tlayers.minmax_partition(weights, perf, feasible)
        assert got == jlayers.minmax_partition(weights, perf, feasible)
    if jlayers.native_available():
        prefix = np.concatenate(([0.0], np.cumsum(weights)))
        assert tlayers.minmax_partition(weights, perf) == (
            jlayers.minmax_partition_native(prefix, perf))


def test_inter_stage_enumeration():
    args = (["A100", "T4"], 16, PARITY_GBS, 10)
    j = [(p.node_sequence, p.device_groups, p.batches)
         for p in jinter.inter_stage_plans(*args)]
    t = [(p.node_sequence, p.device_groups, p.batches)
         for p in tinter.inter_stage_plans(*args)]
    assert t == j and len(t) > 100
    for stages in (1, 2, 3, 5):
        assert list(tdg.enumerate_device_groups(stages, 16, 1.0, 6)) == (
            list(jdg.enumerate_device_groups(stages, 16, 1.0, 6)))
    assert list(tuniform.uniform_plans(num_devices=16, max_tp=4, gbs=64)) == [
        ttypes.UniformPlan(**dataclasses.asdict(p))
        for p in juniform.uniform_plans(num_devices=16, max_tp=4, gbs=64)]


def test_stage_performance(parity_dir):
    out = []
    for cl, st, sp, ty in ((jcluster, jstore, jstage, jtypes),
                           (tcluster, tstore, tstage, ttypes)):
        cluster = _cluster(cl, parity_dir)
        model = sp.StagePerformanceModel(
            cluster, st.ProfileStore.from_dir(parity_dir / "profiles"))
        plan = ty.InterStagePlan(node_sequence=("A100", "T4"),
                                 device_groups=(8, 8), batches=8, gbs=PARITY_GBS)
        strategies = [ty.Strategy(dp=4, tp=2), ty.Strategy(dp=8, tp=1)]
        out.append((list(model.memory_capacity(plan)),
                    list(model.compute_performance(plan, strategies)),
                    sp.rank_device_types(cluster, ("A100", "T4"))))
    assert out[1] == out[0]


def test_event_log_surface(tmp_path):
    """with_fields, bound logs and rotation write the same records.  The
    12 records of ~110 bytes roll the 1000-byte file exactly once, so no
    record is lost whatever the timestamps' lengths."""
    recs, rolls = [], []
    for mod, name in ((jevents, "jax"), (tevents, "port")):
        (tmp_path / name).mkdir()
        path = tmp_path / name / "events.jsonl"
        log = mod.EventLog(path, max_bytes=1000)
        bound = log.with_fields(trace_id="t1", tenant="a")
        for i in range(12):
            bound.emit("tick", i=i, pad="x" * 20)
        bound.with_fields(extra=1).emit("done")
        log.close()
        rows = mod.read_events_rotated(path)
        rolls.append(sum(r["event"] == "event_log_rotated" for r in rows))
        recs.append([{k: v for k, v in r.items() if k != "ts"}
                     for r in rows if r["event"] != "event_log_rotated"])
    assert rolls == [1, 1]
    assert recs[1] == recs[0] and len(recs[1]) == 13
    assert recs[1][-1] == {"event": "done", "trace_id": "t1", "tenant": "a",
                           "extra": 1}


def test_tracer_span_tree():
    kinds = []
    for mod, ev in ((jtrace, jevents), (ttrace, tevents)):
        stream = io.StringIO()
        tracer = mod.Tracer(ev.EventLog(stream=stream))
        with tracer.span("root", a=1):
            with tracer.span("child"):
                tracer.inc("costed", 3)
            acc = tracer.accum("loop")
            for _ in mod.timed_iter(iter(range(3)), acc):
                pass
            acc.close()
        tracer.emit_counters(scope="root")
        rows = [json.loads(line) for line in stream.getvalue().splitlines()]
        kinds.append([(r["event"], r.get("name"), r.get("counters"))
                      for r in rows])
    assert kinds[1] == kinds[0]


def _ledger_records(mod):
    ledger = mod.AccuracyLedger()  # in memory
    for i, (pred, meas) in enumerate([(100.0, 104.0), (200.0, 190.0),
                                      (50.0, 57.5), (80.0, 80.5)]):
        fp = f"plan{i % 2}"
        ledger.record_prediction(fp, pred, model="m",
                                 device_types=["A100", "T4"][i % 2:])
        ledger.record_measurement(fp, meas, source="validate")
    return ledger


def test_accuracy_ledger_and_risk_model():
    j, t = _ledger_records(jledger), _ledger_records(tledger)
    assert dataclasses.asdict(t.summary()) == dataclasses.asdict(j.summary())
    jm, tm = junc.fit_residual_model(j), tunc.fit_residual_model(t)
    assert tm.to_summary() == jm.to_summary()
    for q in (0.5, 0.9, 0.95):
        assert tm.quantile_factor(q, ["A100"]) == jm.quantile_factor(q, ["A100"])
    assert tunc.certificate_confidence(1.5, 2.0, 0.95) == (
        junc.certificate_confidence(1.5, 2.0, 0.95))


def test_plan_fingerprints(parity_dir):
    fps = []
    for api, cl, st, cf, led in ((japi, jcluster, jstore, jconfig, jledger),
                                 (tapi, tcluster, tstore, tconfig, tledger)):
        res = api.plan_uniform(
            _cluster(cl, parity_dir),
            st.ProfileStore.from_dir(parity_dir / "profiles"),
            cf.ModelSpec(**dataclasses.asdict(tiny_test_model())),
            cf.SearchConfig(gbs=PARITY_GBS, max_profiled_tp=4,
                            max_profiled_bs=16), top_k=5)
        fps.append([led.fingerprint_uniform_plan(r.plan) for r in res.plans])
    assert fps[1] == fps[0] and len(set(fps[1])) == 5


def test_risk_ranked_search_matches(parity_dir):
    """Quantile ranking with a residual model fit from the same ledger."""
    dumps = []
    for api, cl, st, cf, ty, led, unc in (
            (japi, jcluster, jstore, jconfig, jtypes, jledger, junc),
            (tapi, tcluster, tstore, tconfig, ttypes, tledger, tunc)):
        model = unc.fit_residual_model(_ledger_records(led))
        res = api.plan_hetero(
            _cluster(cl, parity_dir),
            st.ProfileStore.from_dir(parity_dir / "profiles"),
            cf.ModelSpec(**dataclasses.asdict(tiny_test_model())),
            cf.SearchConfig(gbs=PARITY_GBS, max_profiled_tp=4,
                            max_profiled_bs=16, risk_quantile=0.9,
                            prune_to_top_k=5),
            top_k=5, residual_model=model)
        dumps.append(ty.dump_ranked_plans(res.plans))
    assert dumps[1] == dumps[0]


def test_parallel_workers_match_serial(parity_dir):
    """``workers > 1`` shards the search over processes; the ranking is the
    serial one byte for byte."""
    args = (_cluster(tcluster, parity_dir),
            tstore.ProfileStore.from_dir(parity_dir / "profiles"),
            tconfig.ModelSpec(**dataclasses.asdict(tiny_test_model())))
    base = dict(gbs=PARITY_GBS, max_profiled_tp=4, max_profiled_bs=16,
                strict_compat=True)
    serial = tapi.plan_hetero(*args, tconfig.SearchConfig(**base), top_k=10)
    stream = io.StringIO()
    sharded = tapi.plan_hetero(*args, tconfig.SearchConfig(**base, workers=2),
                               top_k=10, events=tevents.EventLog(stream=stream))
    kinds = [json.loads(line)["event"] for line in stream.getvalue().splitlines()]
    assert "parallel_fallback" not in kinds and "search_finished" in kinds
    assert ttypes.dump_ranked_plans(sharded.plans) == (
        ttypes.dump_ranked_plans(serial.plans))
    assert sharded.num_costed == serial.num_costed

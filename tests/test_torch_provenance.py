"""The port's decision log (``metis_tpu_torch/obs/provenance.py``) and its
``why`` / ``diff`` subcommands against the reference's
(``metis_tpu/obs/provenance.py``, ``metis_tpu/planner/cli.py``).

The reference's ``tests/test_provenance.py`` unit cases run on the port
(all but the fleet drill, ROADMAP §A.9 (e), not ported yet), and the
two packages are held to each other four ways: a log written by either
reads back in the other to equal records; the reference's
``tools/check_decisions_schema.py`` passes the port's logs;
``plan_hetero(decisions=)`` and ``replan(decisions=)`` on the parity
fixture record what the reference records, every field but the time; and
the supervisor's recoveries, on four gloo ranks, record the reference
supervisor's chains in the scenarios of
``tests/torch_supervisor_reference.py``.  ``why`` and ``diff`` print the
reference CLI's bytes and exit codes on the same files, and with
``--remote`` on a live daemon's decision log (an unreachable daemon fails
them as it fails the reference CLI)."""
import dataclasses
import json
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "tools"))

import check_decisions_schema  # noqa: E402

import metis_tpu.cluster.spec as jcluster  # noqa: E402
import metis_tpu.core.config as jconfig  # noqa: E402
import metis_tpu.obs.provenance as jprov  # noqa: E402
import metis_tpu.planner.api as japi  # noqa: E402
import metis_tpu.profiles.store as jstore  # noqa: E402
from metis_tpu.planner.cli import main as ref_main  # noqa: E402
from metis_tpu.profiles import tiny_test_model  # noqa: E402
from metis_tpu.testing import (  # noqa: E402
    PARITY_GBS,
    PARITY_MAX_BS,
    PARITY_MAX_TP,
    write_parity_fixture,
)
import metis_tpu_torch.cluster.spec as tcluster  # noqa: E402
import metis_tpu_torch.core.config as tconfig  # noqa: E402
import metis_tpu_torch.planner.api as tapi  # noqa: E402
import metis_tpu_torch.profiles.store as tstore  # noqa: E402
from metis_tpu_torch.cli import main as port_main  # noqa: E402
from metis_tpu_torch.core.events import EventLog, read_events  # noqa: E402
from metis_tpu_torch.core.types import dump_ranked_plans  # noqa: E402
from metis_tpu_torch.obs.ledger import fingerprint_ranked_plan  # noqa: E402
from metis_tpu_torch.obs.provenance import (  # noqa: E402
    DECISION_KINDS,
    DecisionLog,
    DecisionRecord,
    artifact_digest,
    causal_chain,
    chain_json,
    diff_plans,
    fingerprint_plan_dict,
    plan_axes,
    planner_decision_fields,
    profile_store_digest,
    record_planner_decision,
    render_chain,
)

torch.set_num_threads(1)

# the planner packages export a function ``replan`` that shadows the module
JAX = dict(api=japi, config=jconfig, cluster=jcluster, store=jstore,
           replan=sys.modules["metis_tpu.planner.replan"], prov=jprov)
PORT = dict(api=tapi, config=tconfig, cluster=tcluster, store=tstore,
            replan=sys.modules["metis_tpu_torch.planner.replan"],
            prov=sys.modules[DecisionLog.__module__])


@pytest.fixture(scope="module")
def parity(tmp_path_factory):
    root = tmp_path_factory.mktemp("provenance_parity")
    write_parity_fixture(root)
    return root


def _inputs(pkg, root, **config):
    model = pkg["config"].ModelSpec(**dataclasses.asdict(tiny_test_model()))
    cluster = pkg["cluster"].ClusterSpec.from_files(
        root / "hostfile", root / "clusterfile.json")
    profiles = pkg["store"].ProfileStore.from_dir(root / "profiles")
    search = pkg["config"].SearchConfig(
        gbs=PARITY_GBS, max_profiled_tp=PARITY_MAX_TP,
        max_profiled_bs=PARITY_MAX_BS, **config)
    return cluster, profiles, model, search


@pytest.fixture(scope="module")
def search_result(parity):
    return tapi.plan_hetero(*_inputs(PORT, parity), top_k=4)


def _timeless(rec: dict) -> dict:
    """A record's JSON without its time: ``ts``, and an exact-backend
    certificate's ``wall_s``."""
    out = {k: v for k, v in rec.items() if k != "ts"}
    if out.get("certificate"):
        out["certificate"] = {k: v for k, v in out["certificate"].items()
                              if k != "wall_s"}
    return out


def _lines(path: Path) -> list[dict]:
    return [json.loads(ln) for ln in path.read_text().splitlines() if ln.strip()]


# -- DecisionLog: append-only, seq-numbered, restart-safe ----------------------

class TestDecisionLog:
    def test_seq_assignment_and_queries(self):
        log = DecisionLog(None)
        a = log.record("cold_search", plan_fingerprint="fpA",
                       query_fingerprint="qA")
        b = log.record("cache_hit", plan_fingerprint="fpA", parent_seq=a.seq)
        c = log.record("drift_replan", plan_fingerprint="fpB",
                       parent_seq=a.seq, cause="drift_alarm")
        assert (a.seq, b.seq, c.seq) == (1, 2, 3)
        assert log.last_seq == 3 and len(log) == 3
        assert [r.seq for r in log.records(since=1)] == [2, 3]
        assert log.get(2) is b
        assert log.find(plan_fingerprint="fpA") is b
        assert log.find(kind="cold_search") is a
        assert log.find(plan_fingerprint="nope") is None
        log.resume_seq(10)
        assert log.record("cache_hit").seq == 11

    def test_restart_resumes_sequence(self, tmp_path):
        path = tmp_path / "decisions.jsonl"
        with DecisionLog(path) as log:
            log.record("cold_search", plan_fingerprint="fp1")
            log.record("cache_hit", plan_fingerprint="fp1", parent_seq=1)
        with DecisionLog(path) as log2:
            assert log2.last_seq == 2 and len(log2) == 2
            assert log2.record("drift_replan", plan_fingerprint="fp2",
                               parent_seq=2).seq == 3
        assert [r["seq"] for r in _lines(path)] == [1, 2, 3]
        n, problems = check_decisions_schema.validate_file(path)
        assert n == 3 and not problems

    def test_record_emits_decision_record_event(self, tmp_path):
        ev_path = tmp_path / "events.jsonl"
        with EventLog(ev_path) as events:
            log = DecisionLog(None, events=events)
            log.record("cold_search", plan_fingerprint="fpX",
                       trace_id="trace-1")
            log.record("fleet_repartition")
        evs = read_events(ev_path)
        assert [e["event"] for e in evs] == ["decision_record"] * 2
        assert evs[0]["seq"] == 1 and evs[0]["kind"] == "cold_search"
        assert evs[0]["trace_id"] == "trace-1"
        assert "trace_id" not in evs[1]

    def test_roundtrip_preserves_fields(self, tmp_path):
        path = tmp_path / "d.jsonl"
        with DecisionLog(path) as log:
            log.record("cold_search", plan_fingerprint="fp",
                       query_fingerprint="q", cause="boot", tenant="t0",
                       total_ms=12.5,
                       breakdown={"total_ms": 12.5,
                                  "components": {"compute": 12.5}},
                       runner_up={"plan_fingerprint": "fp2",
                                  "total_ms": 13.0},
                       margin_ms=0.5,
                       confidence={"compute": {"n": 3, "p95_abs_ms": 0.2}},
                       digests={"config": "abc"}, detail={"k": 1})
        rec = DecisionLog(path).get(1)
        assert rec.tenant == "t0" and rec.cause == "boot"
        assert rec.breakdown["components"] == {"compute": 12.5}
        assert rec.runner_up["plan_fingerprint"] == "fp2"
        assert rec.margin_ms == 0.5
        assert rec.confidence["compute"]["p95_abs_ms"] == 0.2
        assert rec.digests == {"config": "abc"} and rec.detail == {"k": 1}

    def test_corrupt_line_is_skipped_on_load(self, tmp_path):
        path = tmp_path / "d.jsonl"
        path.write_text('{"seq": 1, "ts": 1.0, "kind": "cold_search"}\n'
                        "not json\n"
                        '{"seq": 4, "ts": 2.0, "kind": "cache_hit"}\n')
        log = DecisionLog(path)
        assert [r.seq for r in log.records()] == [1, 4] and log.last_seq == 4


# -- the two packages read each other's logs -----------------------------------

def _write_log(prov, path: Path) -> None:
    with prov.DecisionLog(path) as log:
        log.record("cold_search", plan_fingerprint="fpA",
                   query_fingerprint="qA", total_ms=10.0,
                   breakdown={"total_ms": 10.0,
                              "components": {"compute": 7.0, "optimizer": 3.0}},
                   runner_up={"plan_fingerprint": "fpZ", "total_ms": 11.0},
                   margin_ms=1.0, digests={"profiles": "abc"},
                   confidence={"compute": {"n": 2, "p95_abs_ms": 0.5}})
        root = log.record("cluster_delta", cause="device_loss",
                          detail={"step": 4, "removed": {"A100": 2}})
        log.record("delta_replan", plan_fingerprint="fpB",
                   parent_seq=root.seq, cause="device_loss", tenant="web",
                   trace_id="t-9", total_ms=12.0,
                   breakdown={"total_ms": 12.0,
                              "components": {"compute": 8.0, "optimizer": 4.0}},
                   detail={"ranking": "quantile", "risk_quantile": 0.9})


@pytest.mark.parametrize("writer,reader", [(JAX, PORT), (PORT, JAX)],
                         ids=["reference_to_port", "port_to_reference"])
def test_log_written_by_one_package_reads_in_the_other(tmp_path, writer, reader):
    path = tmp_path / "d.jsonl"
    _write_log(writer["prov"], path)
    got = reader["prov"].DecisionLog(path)
    assert [r.to_json_dict() for r in got.records()] == _lines(path)
    assert got.last_seq == 3
    assert [r.seq for r in got.chain(3)] == [2, 3]
    # the JSON of either package's records is the other's, byte for byte
    mine = writer["prov"].DecisionLog(path)
    assert ([json.dumps(r.to_json_dict()) for r in mine.records()]
            == [json.dumps(r.to_json_dict()) for r in got.records()])


def test_same_calls_write_the_same_lines(tmp_path):
    _write_log(jprov, tmp_path / "ref.jsonl")
    _write_log(PORT["prov"], tmp_path / "port.jsonl")
    assert ([_timeless(r) for r in _lines(tmp_path / "port.jsonl")]
            == [_timeless(r) for r in _lines(tmp_path / "ref.jsonl")])


# -- causal chains ----------------------------------------------------------------

def _chaos_log() -> DecisionLog:
    """A preemption fan-out: cluster_delta -> fleet_repartition ->
    tenant_replan -> migration_decision, plus an unrelated root."""
    log = DecisionLog(None)
    log.record("cold_search", plan_fingerprint="fp0")          # seq 1
    root = log.record("cluster_delta", cause="preemption")     # seq 2
    rep = log.record("fleet_repartition", parent_seq=root.seq,
                     cause="preemption")                       # seq 3
    ten = log.record("tenant_replan", plan_fingerprint="fpT",
                     parent_seq=rep.seq, tenant="serve-web",
                     cause="preemption")                       # seq 4
    log.record("migration_decision", plan_fingerprint="fpT",
               parent_seq=ten.seq, cause="preemption",
               detail={"path": "migrate"})                     # seq 5
    return log


class TestCausalChain:
    def test_walks_to_root(self):
        chain = _chaos_log().chain(5)
        assert [r.seq for r in chain] == [2, 3, 4, 5]
        assert chain[0].kind == "cluster_delta"
        assert chain[0].cause == "preemption"

    def test_root_is_its_own_chain(self):
        assert [r.seq for r in _chaos_log().chain(1)] == [1]

    def test_dangling_parent_ends_walk(self):
        recs = [DecisionRecord(seq=7, ts=0.0, kind="tenant_replan",
                               parent_seq=99)]
        assert [r.seq for r in causal_chain(recs, 7)] == [7]

    def test_missing_leaf_is_empty(self):
        assert causal_chain([], 1) == []

    def test_render_and_json(self):
        chain = _chaos_log().chain(5)
        text = render_chain(chain)
        assert "cluster_delta" in text and "preemption" in text
        assert "tenant=serve-web" in text
        payload = chain_json(chain)
        assert payload["depth"] == 4 and payload["root_cause"] == "preemption"
        assert [h["record"]["seq"] for h in payload["hops"]] == [2, 3, 4, 5]

    def test_render_equals_reference(self, tmp_path):
        """The rendered chain and its JSON, risk posture, runner-up,
        confidence and per-hop diffs included, as the reference renders
        the same records."""
        path = tmp_path / "d.jsonl"
        _write_log(jprov, path)
        port = [DecisionRecord.from_json_dict(d) for d in _lines(path)]
        ref = [jprov.DecisionRecord.from_json_dict(d) for d in _lines(path)]
        for leaf in (1, 2, 3):
            pc, rc = causal_chain(port, leaf), jprov.causal_chain(ref, leaf)
            assert render_chain(pc) == jprov.render_chain(rc)
            assert chain_json(pc) == jprov.chain_json(rc)
        assert render_chain([]) == jprov.render_chain([])


# -- plan diff: attribution sums exactly -------------------------------------------

class TestDiffPlans:
    def test_component_deltas_sum_exactly(self, search_result):
        plans = search_result.plans
        assert len(plans) >= 2 and plans[0].breakdown is not None
        diff = diff_plans(plans[0], plans[1])
        assert diff.total_delta_ms == pytest.approx(
            plans[1].cost.total_ms - plans[0].cost.total_ms)
        assert diff.component_delta_sum_ms == pytest.approx(
            diff.total_delta_ms, abs=1e-9)

    def test_axis_changes_detected(self, search_result):
        a = search_result.plans[0].to_json_dict()
        b = dict(a)
        b["node_sequence"] = list(reversed(a["node_sequence"]))
        diff = diff_plans(a, b)
        assert diff.axis_changes["placement"]["b"] == b["node_sequence"]

    def test_identical_plans_diff_to_zero(self, search_result):
        p = search_result.plans[0]
        diff = diff_plans(p, p)
        assert diff.total_delta_ms == 0.0
        assert all(d == 0.0 for d in diff.component_deltas.values())
        assert not diff.axis_changes

    def test_decision_records_diff(self):
        a = DecisionRecord(
            seq=1, ts=0.0, kind="cold_search", plan_fingerprint="fpA",
            total_ms=10.0,
            breakdown={"total_ms": 10.0,
                       "components": {"compute": 7.0, "optimizer": 3.0}})
        b = DecisionRecord(
            seq=2, ts=0.0, kind="drift_replan", plan_fingerprint="fpB",
            total_ms=12.0,
            breakdown={"total_ms": 12.0,
                       "components": {"compute": 8.5, "optimizer": 3.5}})
        diff = diff_plans(a, b)
        assert diff.total_delta_ms == pytest.approx(2.0)
        assert diff.component_deltas["compute"] == pytest.approx(1.5)
        assert diff.decisive == ("compute", pytest.approx(1.5))
        assert diff.component_delta_sum_ms == pytest.approx(
            diff.total_delta_ms, abs=1e-9)
        assert "compute" in diff.render()

    def test_plan_axes_and_fingerprint_roundtrip(self, search_result):
        d = search_result.plans[0].to_json_dict()
        axes = plan_axes(d)
        assert axes["stages"] == d["num_stages"]
        assert axes["layer_cut"] == list(d["layer_partition"])
        assert fingerprint_plan_dict(d) == fingerprint_ranked_plan(
            search_result.plans[0])

    def test_diff_equals_reference(self, parity, search_result):
        """``diff_plans`` of the port's ranked plans and of their dump
        entries, rendered and as JSON, against the reference's diff of the
        reference's search (the two searches' dumps are byte-identical)."""
        ref = japi.plan_hetero(*_inputs(JAX, parity), top_k=4)
        dumps = [json.loads(dump_ranked_plans(r.plans)) for r in
                 (search_result, ref)]
        assert dumps[0] == dumps[1]
        for i, j in ((0, 1), (0, 3), (2, 1)):
            p = diff_plans(search_result.plans[i], search_result.plans[j])
            r = jprov.diff_plans(ref.plans[i], ref.plans[j])
            assert p.to_json_dict() == r.to_json_dict()
            assert p.render() == r.render()
            pd = diff_plans(dumps[0][i], dumps[0][j])
            assert pd.to_json_dict() == jprov.diff_plans(
                dumps[1][i], dumps[1][j]).to_json_dict()


# -- planner-result extraction -------------------------------------------------------

class TestPlannerDecisionFields:
    def test_fields_from_result(self, search_result):
        fields = planner_decision_fields(search_result)
        best = search_result.plans[0]
        assert fields["total_ms"] == best.cost.total_ms
        assert fields["breakdown"]["total_ms"] == pytest.approx(
            best.cost.total_ms)
        assert fields["margin_ms"] == pytest.approx(
            search_result.plans[1].cost.total_ms - best.cost.total_ms)
        assert fields["runner_up"]["total_ms"] == \
            search_result.plans[1].cost.total_ms

    def test_record_planner_decision(self, search_result):
        log = DecisionLog(None)
        rec = record_planner_decision(log, search_result, cause="boot",
                                      tenant="t1")
        assert rec is not None and rec.seq == 1
        assert rec.kind == "cold_search" and rec.tenant == "t1"
        assert rec.breakdown is not None
        assert record_planner_decision(None, search_result) is None

    def test_artifact_digest_is_canonical(self):
        assert artifact_digest({"a": 1, "b": 2}) == \
            artifact_digest({"b": 2, "a": 1})
        assert artifact_digest({"a": 1}) != artifact_digest({"a": 2})
        assert len(artifact_digest([1, 2, 3])) == 12
        assert artifact_digest({"x": [1, 2]}) == jprov.artifact_digest({"x": [1, 2]})

    def test_profile_store_digest_equals_reference(self, parity):
        _, tprof, _, _ = _inputs(PORT, parity)
        _, jprof, _, _ = _inputs(JAX, parity)
        assert profile_store_digest(tprof) == jprov.profile_store_digest(jprof)
        assert profile_store_digest(object()) == ""


# -- the recording entry points against the reference's ---------------------------

PLAN_CASES = {
    "defaults": ({}, None),
    "exact": (dict(backend="exact"), None),
    "meta": ({}, dict(kind="drift_replan", cause="drift_alarm",
                      parent_seq=None, tenant="web", trace_id="t-1",
                      query_fingerprint="q", detail={"why": "test"})),
}


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_plan_hetero_records_as_reference(parity, tmp_path, case):
    """``plan_hetero(decisions=)`` on the parity fixture: the port's
    record equals the reference's in every field but the time."""
    config, meta = PLAN_CASES[case]
    paths = {}
    for name, pkg in (("ref", JAX), ("port", PORT)):
        paths[name] = tmp_path / f"{name}.jsonl"
        with pkg["prov"].DecisionLog(paths[name]) as log:
            pkg["api"].plan_hetero(*_inputs(pkg, parity, **config), top_k=5,
                                   decisions=log, decision_meta=meta)
    port, ref = _lines(paths["port"]), _lines(paths["ref"])
    assert len(port) == 1 and port[0]["breakdown"] and port[0]["runner_up"]
    assert [_timeless(r) for r in port] == [_timeless(r) for r in ref]
    assert check_decisions_schema.validate_decisions(port) == []


def test_replan_chain_records_as_reference(parity, tmp_path):
    """A full search, then ``replan(decisions=)`` after losing four A100s
    under a ``cluster_delta`` root: three records, the replan a child of the
    root, equal to the reference's; ``why`` walks it as the reference's."""
    paths = {}
    for name, pkg in (("ref", JAX), ("port", PORT)):
        paths[name] = tmp_path / f"{name}.jsonl"
        cluster, profiles, model, search = _inputs(pkg, parity)
        with pkg["prov"].DecisionLog(paths[name]) as log:
            pkg["api"].plan_hetero(cluster, profiles, model, search, top_k=3,
                                   decisions=log)
            root = log.record("cluster_delta", cause="device_loss",
                              detail={"removed": {"A100": 4}})
            survivor = pkg["replan"].shrink_cluster(cluster, {"A100": 4})
            pkg["replan"].replan(cluster, survivor, profiles, model, search,
                                 search_old=False, decisions=log,
                                 decision_meta={"cause": "device_loss",
                                                "parent_seq": root.seq})
    port, ref = _lines(paths["port"]), _lines(paths["ref"])
    assert [r["kind"] for r in port] == ["cold_search", "cluster_delta",
                                          "delta_replan"]
    assert port[2]["parent_seq"] == 2
    assert [_timeless(r) for r in port] == [_timeless(r) for r in ref]
    n, problems = check_decisions_schema.validate_file(paths["port"])
    assert n == 3 and not problems


SUPERVISOR_SCENARIOS = {
    # one device loss, migrated live: root -> replan -> migration
    "migrate": ("device_loss@4:A100=2", dict(checkpoint_every=2)),
    # a spot eviction and its return: two chains
    "spot": ("spot_preemption@3,spot_return@5", dict(checkpoint_every=2)),
}


@pytest.fixture(scope="module")
def supervisor_runs(tmp_path_factory):
    """The reference's supervisor and the port's four gloo ranks, each with
    a decision log, in the scenarios above (both at once: the port's in a
    thread)."""
    import torch_supervisor_reference as sref
    from metis_tpu.core.config import ResilienceConfig as JResilienceConfig
    from metis_tpu.core.events import EventLog as JEventLog
    from metis_tpu.resilience import FaultInjector as JFaultInjector
    from metis_tpu_torch.execution import dist as tdist
    from metis_tpu_torch.resilience.supervisor import supervised_rank

    root = tmp_path_factory.mktemp("supervisor_decisions")
    s = sref.setup(root)

    def port():
        out = {}
        with tdist.RankPool(sref.WORLD, "gloo", ["cpu"] * sref.WORLD) as pool:
            for name, (script, res) in SUPERVISOR_SCENARIOS.items():
                job = sref.port_job(s, name, script, res)
                job["decisions"] = str(root / f"port_{name}_decisions.jsonl")
                out[name] = pool.run(supervised_rank, job)
        return out

    with ThreadPoolExecutor(1) as threads:
        ranks = threads.submit(port)
        for name, (script, res) in SUPERVISOR_SCENARIOS.items():
            with JEventLog(root / f"ref_{name}.jsonl") as events, \
                    jprov.DecisionLog(root / f"ref_{name}_decisions.jsonl") as log:
                sref._Recording(
                    s["cluster"], s["profiles"], s["model"], s["config"],
                    checkpoint_dir=root / f"ref_ckpt_{name}", steps=sref.STEPS,
                    resilience=JResilienceConfig(**res),
                    faults=JFaultInjector(script, seed=0, events=events),
                    events=events, sleep=sref._no_sleep,
                    decisions=log).run()
        ranks = ranks.result()
    return root, ranks


@pytest.mark.parametrize("name", sorted(SUPERVISOR_SCENARIOS))
def test_supervisor_records_as_reference(supervisor_runs, name):
    root, ranks = supervisor_runs
    assert all(r["report"]["outcome"] == "completed" for r in ranks[name])
    port = _lines(root / f"port_{name}_decisions.jsonl")
    ref = _lines(root / f"ref_{name}_decisions.jsonl")
    assert [r["kind"] for r in port].count("migration_decision") == len(
        ranks[name][0]["report"]["recoveries"])
    assert [_timeless(r) for r in port] == [_timeless(r) for r in ref]
    assert check_decisions_schema.validate_decisions(port) == []
    leaf = port[-1]
    chain = causal_chain([DecisionRecord.from_json_dict(d) for d in port],
                         leaf["seq"])
    assert [r.kind for r in chain] == ["cluster_delta", "delta_replan",
                                       "migration_decision"]


# -- the decision-schema checker ------------------------------------------------------

class TestDecisionsSchemaChecker:
    def _valid(self):
        return [
            {"seq": 1, "ts": 1.0, "kind": "cold_search"},
            {"seq": 2, "ts": 2.0, "kind": "cache_hit", "parent_seq": 1},
            {"seq": 5, "ts": 3.0, "kind": "drift_replan", "parent_seq": 1,
             "breakdown": {"total_ms": 10.0,
                           "components": {"compute": 6.0, "optimizer": 4.0}}},
        ]

    def test_valid_log_passes(self):
        assert check_decisions_schema.validate_decisions(self._valid()) == []

    def test_port_log_passes(self, tmp_path):
        path = tmp_path / "d.jsonl"
        _write_log(PORT["prov"], path)
        n, problems = check_decisions_schema.validate_file(path)
        assert n == 3 and not problems
        assert check_decisions_schema.main([str(path)]) == 0

    def test_unknown_kind_flagged(self):
        recs = self._valid()
        recs[0]["kind"] = "vibes"
        assert any("unknown decision kind" in p for p in
                   check_decisions_schema.validate_decisions(recs))

    def test_non_monotonic_seq_flagged(self):
        recs = self._valid()
        recs[2]["seq"] = 2
        assert any("strictly increasing" in p for p in
                   check_decisions_schema.validate_decisions(recs))

    def test_dangling_parent_flagged(self):
        recs = self._valid()
        recs[1]["parent_seq"] = 42
        assert any("does not resolve" in p for p in
                   check_decisions_schema.validate_decisions(recs))

    def test_breakdown_additivity_enforced(self):
        recs = self._valid()
        recs[2]["breakdown"]["components"]["compute"] = 99.0
        assert any("additivity violated" in p for p in
                   check_decisions_schema.validate_decisions(recs))

    def test_kinds_stay_in_sync(self):
        assert tuple(check_decisions_schema.DECISION_KINDS) == DECISION_KINDS
        assert DECISION_KINDS == jprov.DECISION_KINDS


# -- the why / diff CLI ------------------------------------------------------------------

@pytest.fixture()
def decisions_file(tmp_path):
    path = tmp_path / "decisions.jsonl"
    with DecisionLog(path) as log:
        log.record(
            "cold_search", plan_fingerprint="fpA", query_fingerprint="qfpA",
            total_ms=10.0,
            breakdown={"total_ms": 10.0,
                       "components": {"compute": 7.0, "optimizer": 3.0}})
        root = log.record("cluster_delta", cause="preemption")
        log.record(
            "delta_replan", plan_fingerprint="fpB", parent_seq=root.seq,
            cause="preemption", tenant="web", total_ms=12.0,
            breakdown={"total_ms": 12.0,
                       "components": {"compute": 8.0, "optimizer": 4.0}})
    return path


def _same(capsys, argv, rc):
    out = []
    for main in (ref_main, port_main):
        capsys.readouterr()
        out.append((main(list(argv)), capsys.readouterr().out))
    assert out[1] == out[0] and out[1][0] == rc
    return out[1][1]


WHY_CASES = {
    "fingerprint_json": (["fpB", "--json"], 0),
    "fingerprint": (["fpB"], 0),
    "query_fingerprint": (["qfpA", "--json"], 0),
    "tenant": (["--tenant", "web"], 0),
    "seq": (["--seq", "2", "--json"], 0),
    "unknown": (["nope"], 1),
    "unknown_seq": (["--seq", "9"], 1),
    "no_leaf": ([], 2),
}


@pytest.mark.parametrize("case", WHY_CASES)
def test_why_equals_reference(decisions_file, capsys, case):
    argv, rc = WHY_CASES[case]
    out = _same(capsys, ["why", *argv, "--decisions", str(decisions_file)], rc)
    if case == "fingerprint_json":
        payload = json.loads(out)
        assert payload["depth"] == 2 and payload["root_cause"] == "preemption"
        assert payload["hops"][0]["record"]["kind"] == "cluster_delta"


def test_why_missing_log_or_source_exits_1(tmp_path, capsys):
    _same(capsys, ["why", "fpA", "--decisions", str(tmp_path / "no.jsonl")], 1)
    _same(capsys, ["why", "fpA"], 1)


DIFF_CASES = {
    "decisions_json": (["fpA", "fpB", "--json"], 0),
    "decisions": (["fpA", "fpB"], 0),
    "reversed": (["fpB", "fpA"], 0),
    "unknown": (["fpA", "ghost"], 1),
}


@pytest.mark.parametrize("case", DIFF_CASES)
def test_diff_equals_reference(decisions_file, capsys, case):
    argv, rc = DIFF_CASES[case]
    out = _same(capsys, ["diff", *argv, "--decisions", str(decisions_file)], rc)
    if case == "decisions_json":
        payload = json.loads(out)
        assert payload["total_delta_ms"] == pytest.approx(2.0)
        assert sum(payload["component_deltas"].values()) == pytest.approx(
            payload["total_delta_ms"], abs=1e-9)


def test_diff_from_plan_dump_equals_reference(search_result, tmp_path, capsys):
    dump = tmp_path / "plans.json"
    dump.write_text(dump_ranked_plans(search_result.plans))
    fps = [fingerprint_plan_dict(p) for p in json.loads(dump.read_text())]
    for a, b in ((0, 1), (1, 3)):
        payload = json.loads(_same(capsys, ["diff", fps[a], fps[b], "--plans",
                                            str(dump), "--json"], 0))
        assert payload["fingerprint_a"] == fps[a]
        assert sum(payload["component_deltas"].values()) == pytest.approx(
            payload["total_delta_ms"] or 0.0, abs=1e-9)
        _same(capsys, ["diff", fps[a], fps[b], "--plans", str(dump)], 0)


def test_diff_without_plans_or_bad_dump(tmp_path, capsys):
    _same(capsys, ["diff", "a", "b"], 2)
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    _same(capsys, ["diff", "a", "b", "--plans", str(bad)], 1)


@pytest.mark.parametrize("argv", [["why", "fpA"], ["diff", "fpA", "fpB"]],
                         ids=["why", "diff"])
def test_remote_exits_2_naming_the_item(decisions_file, capsys, argv):
    """``--remote`` wins over ``--decisions``; an unreachable daemon fails
    both CLIs with the same error and prints nothing."""
    argv = [*argv, "--remote", "unix:/nonexistent.sock",
            "--decisions", str(decisions_file)]
    got = []
    for main in (ref_main, port_main):
        capsys.readouterr()
        with pytest.raises(Exception) as e:
            main(list(argv))
        got.append((type(e.value).__name__, str(e.value),
                    capsys.readouterr()))
    assert got[1][:2] == got[0][:2]
    assert got[1][0] == "ServeClientError"
    assert got[0][2] == got[1][2] == ("", "")


def test_why_and_diff_remote_on_a_live_daemon(parity, tmp_path, capsys):
    """A port daemon with a decision log on disk: a cold search, then a
    cluster delta whose replan records a ``delta_replan``.  ``why`` and
    ``diff`` with ``--remote`` print, in both CLIs, the bytes the port's
    in-process ``why`` / ``diff`` print on the daemon's log file."""
    from metis_tpu_torch.serve.daemon import PlanService, serve_in_thread

    cluster, store, model, config = _inputs(PORT, parity)
    path = tmp_path / "daemon_decisions.jsonl"
    service = PlanService(cluster, store, decisions=DecisionLog(path))
    server, thread, address = serve_in_thread(service)
    try:
        first = service.plan_query(model, config, top_k=3)
        seq = service.apply_cluster_delta(removed={"A100": 4},
                                          replan=True)["seq"]
        for _ in range(30):
            if any(n["kind"] == "replan_push" for n in
                   service.notifications(since=seq, timeout_s=2.0)):
                break
        second = [r for r in service.decisions.records()
                  if r.kind == "delta_replan"][-1]
        cases = [["why", second.plan_fingerprint, "--json"],
                 ["why", second.plan_fingerprint],
                 ["diff", first["plan_fingerprint"], second.plan_fingerprint],
                 ["diff", first["plan_fingerprint"], second.plan_fingerprint,
                  "--json"]]
        for argv in cases:
            capsys.readouterr()
            assert port_main([*argv, "--decisions", str(path)]) == 0
            local = capsys.readouterr().out
            for main in (port_main, ref_main):
                assert main([*argv, "--remote", address]) == 0
                assert capsys.readouterr().out == local
            if argv[0] == "diff" and argv[-1] == "--json":
                payload = json.loads(local)
                total = payload["total_delta_ms"]
                assert sum(payload["component_deltas"].values()) == \
                    pytest.approx(total, rel=1e-9)
    finally:
        server.shutdown()
        thread.join(10)
        server.server_close()

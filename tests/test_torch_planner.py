"""The port's planner against the JAX package's, on the same inputs.

Both packages read the parity fixtures of ``metis_tpu.testing`` (2 A100 + 2
T4 nodes, 4 devices each; the spot variant marks the T4 pool spot-tier),
written to ``tmp_path``.  Their rankings, breakdowns and CLI outputs must be
the same bytes: the planner is host-side numpy in both packages, so there is
no tolerance to state.
"""
import dataclasses
import json
import math

import numpy as np
import pytest
import torch

import metis_tpu.cluster.spec as jcluster
import metis_tpu.core.config as jconfig
import metis_tpu.core.types as jtypes
import metis_tpu.cost.estimator as jest
import metis_tpu.cost.volume as jvolume
import metis_tpu.execution.mesh as jmesh
import metis_tpu.planner.api as japi
import metis_tpu.planner.cli as jcli
import metis_tpu.profiles.store as jstore
from metis_tpu.profiles import tiny_test_model
from metis_tpu.testing import (
    PARITY_GBS,
    PARITY_MAX_BS,
    PARITY_MAX_TP,
    write_parity_fixture,
    write_spot_parity_fixture,
)
import metis_tpu_torch.cluster.spec as tcluster
import metis_tpu_torch.core.config as tconfig
import metis_tpu_torch.core.types as ttypes
import metis_tpu_torch.cost.estimator as test_
import metis_tpu_torch.cost.volume as tvolume
import metis_tpu_torch.execution.mesh as tmesh
import metis_tpu_torch.planner.api as tapi
import metis_tpu_torch.profiles.store as tstore
from metis_tpu_torch import cli as tcli
from metis_tpu_torch.core.errors import MetisError

# the suite runs in several workers at once; one intra-op thread keeps the
# CPU train step from contending with the other workers
torch.set_num_threads(1)

JAX = dict(api=japi, config=jconfig, cluster=jcluster, store=jstore,
           types=jtypes)
PORT = dict(api=tapi, config=tconfig, cluster=tcluster, store=tstore,
            types=ttypes)


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    root = tmp_path_factory.mktemp("planner_parity")
    write_parity_fixture(root / "parity")
    write_spot_parity_fixture(root / "spot")
    return root


def _inputs(pkg, fixture_dir, **config):
    model = pkg["config"].ModelSpec(**dataclasses.asdict(tiny_test_model()))
    cluster = pkg["cluster"].ClusterSpec.from_files(
        fixture_dir / "hostfile", fixture_dir / "clusterfile.json")
    profiles = pkg["store"].ProfileStore.from_dir(fixture_dir / "profiles")
    search = pkg["config"].SearchConfig(
        gbs=PARITY_GBS, max_profiled_tp=PARITY_MAX_TP,
        max_profiled_bs=PARITY_MAX_BS, **config)
    return cluster, profiles, model, search


def _hetero(pkg, fixture_dir, **config):
    return pkg["api"].plan_hetero(*_inputs(pkg, fixture_dir, **config),
                                  top_k=20)


HETERO_CASES = {
    "strict_compat": ("parity", dict(strict_compat=True)),
    "defaults": ("parity", {}),
    "prune_top10": ("parity", dict(prune_to_top_k=10)),
    "exact": ("parity", dict(backend="exact")),
    "spot": ("spot", {}),
}


@pytest.mark.parametrize("case", sorted(HETERO_CASES))
def test_plan_hetero_dump_is_byte_identical(fixtures, case):
    fixture, config = HETERO_CASES[case]
    j = _hetero(JAX, fixtures / fixture, **config)
    t = _hetero(PORT, fixtures / fixture, **config)
    assert t.plans, "the search costed no plan"
    assert ttypes.dump_ranked_plans(t.plans) == jtypes.dump_ranked_plans(j.plans)
    assert (t.num_costed, t.num_pruned, t.num_bound_pruned) == (
        j.num_costed, j.num_pruned, j.num_bound_pruned)
    if config.get("backend") == "exact":
        jc, tc = j.certificate.to_json_dict(), t.certificate.to_json_dict()
        # wall time is each search's own clock; every other field is exact
        jc.pop("wall_s"), tc.pop("wall_s")
        assert tc == jc and tc["complete"]
    else:
        assert t.certificate is None and j.certificate is None


def _uniform_payload(result) -> str:
    """The ``uniform`` subcommand's JSON (both CLIs write this shape)."""
    return json.dumps([
        {"rank": i + 1, "cost_ms": r.cost.total_ms,
         "cost_breakdown": dataclasses.asdict(r.cost),
         "plan": dataclasses.asdict(r.plan), "device_type": r.device_type}
        for i, r in enumerate(result.plans)], indent=2)


@pytest.mark.parametrize("strict", [True, False], ids=["strict", "default"])
def test_plan_uniform_payload_is_byte_identical(fixtures, strict):
    out = []
    for pkg in (JAX, PORT):
        res = pkg["api"].plan_uniform(
            *_inputs(pkg, fixtures / "parity", strict_compat=strict),
            include_oom=True)
        out.append((_uniform_payload(res), res.num_costed, res.num_pruned,
                    res.num_oom_excluded))
    assert out[0][0] != "[]"
    assert out[1] == out[0]


def test_hetero_breakdowns_equal_to_the_last_bit(fixtures):
    j = _hetero(JAX, fixtures / "parity")
    t = _hetero(PORT, fixtures / "parity")
    assert len(t.plans) == 20
    for jp, tp in zip(j.plans, t.plans):
        assert tp.breakdown is not None
        assert tp.breakdown.components == jp.breakdown.components
        assert dataclasses.asdict(tp.breakdown) == dataclasses.asdict(
            jp.breakdown)
        assert math.fsum(tp.breakdown.components.values()) == pytest.approx(
            tp.cost.total_ms, rel=1e-12)


@pytest.mark.parametrize("strict", [True, False], ids=["strict", "default"])
def test_uniform_breakdowns_equal_to_the_last_bit(fixtures, strict):
    """Every uniform plan of the sweep, priced by both packages' estimators."""
    from metis_tpu.search.uniform import uniform_plans

    pairs = []
    for pkg, est, vol in ((JAX, jest, jvolume), (PORT, test_, tvolume)):
        cluster, profiles, model, config = _inputs(
            pkg, fixtures / "parity", strict_compat=strict)
        pairs.append(est.UniformCostEstimator(
            cluster, profiles,
            vol.TransformerVolume(model, profiles.model.params_per_layer_bytes),
            est.EstimatorOptions.from_config(config)))
    jax_est, port_est = pairs
    compared = 0
    for plan in uniform_plans(num_devices=16, max_tp=PARITY_MAX_TP,
                              gbs=PARITY_GBS):
        if plan.mbs > PARITY_MAX_BS:
            continue
        tplan = ttypes.UniformPlan(**dataclasses.asdict(plan))
        for dtype in ("A100", "T4"):
            try:
                jc, jb = jax_est.get_breakdown(plan, dtype)
            except KeyError:
                with pytest.raises(KeyError):
                    port_est.get_breakdown(tplan, dtype)
                continue
            tc, tb = port_est.get_breakdown(tplan, dtype)
            assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
            assert dataclasses.asdict(tb) == dataclasses.asdict(jb)
            compared += 1
    assert compared > 20


def _cli_args(fixture_dir, command, out):
    return [command, "--hostfile", str(fixture_dir / "hostfile"),
            "--clusterfile", str(fixture_dir / "clusterfile.json"),
            "--profile-dir", str(fixture_dir / "profiles"),
            "--num-layers", "10", "--hidden-size", "4096", "--seq-len", "1024",
            "--vocab-size", "51200", "--num-heads", "32",
            "--gbs", str(PARITY_GBS), "--max-tp", str(PARITY_MAX_TP),
            "--max-bs", str(PARITY_MAX_BS), "--top-k", "10",
            "--output", str(out)]


@pytest.mark.parametrize("command,extra", [
    ("hetero", []), ("hetero", ["--strict-compat"]),
    ("uniform", ["--include-oom"]), ("uniform", ["--strict-compat"]),
], ids=["hetero", "hetero-strict", "uniform", "uniform-strict"])
def test_cli_writes_the_same_bytes(fixtures, tmp_path, command, extra):
    outs = []
    for name, main in (("jax", jcli.main), ("port", tcli.main)):
        out = tmp_path / f"{name}.json"
        assert main(_cli_args(fixtures / "parity", command, out) + extra) == 0
        outs.append(out.read_bytes())
    assert outs[0] == outs[1] and len(json.loads(outs[1])) > 0


SPEC = dict(name="tiny", num_layers=4, hidden_size=64, sequence_length=32,
            vocab_size=128, num_heads=4, attn="flash")


@pytest.fixture(scope="module")
def port_profile(tmp_path_factory):
    """A profile directory measured by the port on the CPU."""
    from metis_tpu_torch.profiles.profiler import ProfilerConfig, profile_model

    out = tmp_path_factory.mktemp("port_cpu_profile")
    store = profile_model(tconfig.ModelSpec(**SPEC), tps=(1,), bss=(1, 2, 4),
                          device="cpu", config=ProfilerConfig(warmup=1, iters=1))
    store.dump_to_dir(out, {"model_name": SPEC["name"], "attn": SPEC["attn"]})
    (out / "hostfile").write_text("127.0.0.1 slots=1\n")
    (out / "clusterfile.json").write_text(json.dumps({"127.0.0.1": {
        "instance_type": "CPU", "memory": 8, "intra_bandwidth": 450,
        "inter_bandwidth": 50}}))
    return out


@pytest.mark.parametrize("strict", [True, False], ids=["strict", "default"])
def test_port_profile_plans_the_same_in_both_packages(port_profile, strict):
    costs = []
    for pkg in (JAX, PORT):
        cluster = pkg["cluster"].ClusterSpec.from_files(
            port_profile / "hostfile", port_profile / "clusterfile.json")
        res = pkg["api"].plan_uniform(
            cluster, pkg["store"].ProfileStore.from_dir(port_profile),
            pkg["config"].ModelSpec(**SPEC),
            pkg["config"].SearchConfig(gbs=4, max_profiled_tp=1,
                                       max_profiled_bs=4, strict_compat=strict),
            include_oom=True)
        costs.append([(dataclasses.asdict(r.plan), dataclasses.asdict(r.cost))
                      for r in res.plans])
    assert len(costs[1]) == 3 and costs[1] == costs[0]


def test_validate_planner_choice_on_the_host(port_profile):
    from metis_tpu_torch.validation import validate_planner_choice

    cluster = tcluster.ClusterSpec.from_files(
        port_profile / "hostfile", port_profile / "clusterfile.json")
    model = tconfig.ModelSpec(**SPEC)
    res = tapi.plan_uniform(
        cluster, tstore.ProfileStore.from_dir(port_profile), model,
        tconfig.SearchConfig(gbs=4, max_profiled_tp=1, max_profiled_bs=4),
        include_oom=True)
    reports = validate_planner_choice(res.plans, model, device="cpu", top_k=2,
                                      steps=2, warmup=1)
    assert [r.plan for r in reports] == [r.plan for r in res.plans[:2]]
    for r, ranked in zip(reports, res.plans):
        assert r.predicted_ms == ranked.cost.total_ms
        assert r.measured_ms > 0 and np.isfinite(r.error_pct)


def test_cli_validate_on_the_host(port_profile, tmp_path):
    out, ledger = tmp_path / "validate.json", tmp_path / "ledger.jsonl"
    args = ["validate", "--hostfile", str(port_profile / "hostfile"),
            "--clusterfile", str(port_profile / "clusterfile.json"),
            "--profile-dir", str(port_profile), "--num-layers", "4",
            "--hidden-size", "64", "--seq-len", "32", "--vocab-size", "128",
            "--num-heads", "4", "--attn", "flash", "--gbs", "4",
            "--max-tp", "1", "--max-bs", "4", "--validate-top-k", "3",
            "--steps", "2", "--warmup", "1", "--device", "cpu",
            "--output", str(out), "--ledger", str(ledger)]
    assert tcli.main(args) == 0
    payload = json.loads(out.read_text())
    assert sorted(p["plan"]["mbs"] for p in payload["plans"]) == [1, 2, 4]
    assert all(math.isfinite(p["error_pct"]) for p in payload["plans"])
    assert payload["calibration"]["gspmd"]["fit_points"] == 3
    assert len(payload["calibrated_plans"]) == 3
    kinds = [json.loads(line)["kind"] for line in ledger.read_text().splitlines()]
    assert kinds.count("prediction") == 3 and kinds.count("measurement") == 3


def test_affine_loo_matches_the_reference():
    from metis_tpu.validation import ValidationReport as JReport
    from metis_tpu.validation import affine_loo_calibrated as jfit
    from metis_tpu_torch.validation import ValidationReport as TReport
    from metis_tpu_torch.validation import affine_loo_calibrated as tfit

    rows = [(100.0, 110.0), (200.0, 190.0), (300.0, 330.0), (50.0, 70.0)]
    for n in (1, 2, 4):
        jr = [JReport(jtypes.UniformPlan(1, 1, 1, 1, 4), p, m, 5)
              for p, m in rows[:n]]
        tr = [TReport(ttypes.UniformPlan(1, 1, 1, 1, 4), p, m, 5)
              for p, m in rows[:n]]
        (jf, jl), (tf, tl) = jfit(jr), tfit(tr)
        assert tf == jf
        assert [r.to_json_dict() for r in tl] == [r.to_json_dict() for r in jl]


def test_cost_backend_jax_raises():
    with pytest.raises(MetisError, match="numpy"):
        tconfig.SearchConfig(gbs=8, cost_backend="jax")
    with pytest.raises(ValueError):
        tconfig.SearchConfig(gbs=8, cost_backend="cupy")
    # an estimator built around the SearchConfig check raises as well
    from metis_tpu_torch.cost.batch import BatchCostEstimator

    class _Scalar:
        options = test_.EstimatorOptions(cost_backend="jax")

    with pytest.raises(MetisError, match="numpy"):
        BatchCostEstimator(_Scalar())


def test_h100_preset():
    spec = tcluster.DEVICE_REGISTRY["H100"]
    assert spec.memory_mb == 81920
    assert spec.hbm_gbps == 3350
    assert (spec.intra_bw_gbps, spec.inter_bw_gbps) == (50, 10)
    # every reference preset is carried over unchanged
    for name, ref in jcluster.DEVICE_REGISTRY.items():
        assert dataclasses.asdict(tcluster.DEVICE_REGISTRY[name]) == (
            dataclasses.asdict(ref))


def test_ranked_plan_artifact_builds_and_steps(port_profile):
    from metis_tpu_torch.execution.builder import build_executable
    from metis_tpu_torch.models import config_for_model_spec

    model = tconfig.ModelSpec(**SPEC)
    cluster = tcluster.ClusterSpec.from_files(
        port_profile / "hostfile", port_profile / "clusterfile.json")
    res = tapi.plan_hetero(
        cluster, tstore.ProfileStore.from_dir(port_profile), model,
        tconfig.SearchConfig(gbs=4, max_profiled_tp=1, max_profiled_bs=4),
        top_k=3)
    best = res.best
    art = tmesh.PlanArtifact.from_ranked_plan(best)
    assert art.mesh_shape == (1, 1, 1, 1, 1) and len(art.strategies) == 1
    # the JSON contract is the reference's, byte for byte
    jbest = japi.plan_hetero(
        jcluster.ClusterSpec.from_files(port_profile / "hostfile",
                                        port_profile / "clusterfile.json"),
        jstore.ProfileStore.from_dir(port_profile),
        jconfig.ModelSpec(**SPEC),
        jconfig.SearchConfig(gbs=4, max_profiled_tp=1, max_profiled_bs=4),
        top_k=3).best
    assert art.to_json() == jmesh.PlanArtifact.from_ranked_plan(jbest).to_json()

    cfg = config_for_model_spec(model)
    exe = build_executable(cfg, art, device="cpu")
    state = exe.init(0)
    tokens = torch.randint(0, cfg.vocab_size, (art.gbs, cfg.seq_len),
                           generator=torch.Generator().manual_seed(1))
    state, loss = exe.step(state, tokens, tokens.roll(-1, 1))
    assert math.isfinite(loss.item()) and state.step == 1

    two = dataclasses.replace(
        best, inter=dataclasses.replace(best.inter, device_groups=(2,)),
        intra=dataclasses.replace(best.intra, strategies=(
            ttypes.Strategy(dp=2, tp=1),)))
    # a dp 2 plan runs on two ranks, started by the launcher
    with pytest.raises(MetisError, match="through the launcher"):
        build_executable(cfg, tmesh.PlanArtifact.from_ranked_plan(two),
                         device="cpu")


def test_decision_log_is_not_ported_yet(fixtures):
    with pytest.raises(NotImplementedError, match="provenance"):
        tapi.plan_hetero(*_inputs(PORT, fixtures / "parity"),
                         decisions=object())

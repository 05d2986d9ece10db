"""``planner/replan.py`` and the ``replan`` subcommand of the port against
the JAX package's, on the same clusters and profiles.

The delta arithmetic (``ClusterDelta``, ``shrink_cluster``,
``grow_cluster``) must give the same topologies and refuse the same
requests with the same messages; ``replan`` the same report (delta,
``plan_changed``, costs within 1e-9 relative, the best plan's
``PlanArtifact`` JSON byte for byte); the subcommand the same bytes.  The
planner is host numpy in both packages.
"""
import json
import math

import pytest
import torch

import metis_tpu.cluster.spec as jcluster
import metis_tpu.core.config as jconfig
import metis_tpu.core.errors as jerrors
import metis_tpu.execution.mesh as jmesh
import metis_tpu.planner as jplanner
import metis_tpu.planner.cli as jcli
import metis_tpu.profiles.store as jstore
from metis_tpu.profiles import synthesize_profiles, tiny_test_model
from metis_tpu.testing import (
    PARITY_GBS,
    PARITY_MAX_BS,
    PARITY_MAX_TP,
    write_parity_fixture,
)
import metis_tpu_torch.cluster.spec as tcluster
import metis_tpu_torch.core.config as tconfig
import metis_tpu_torch.core.errors as terrors
import metis_tpu_torch.execution.mesh as tmesh
import metis_tpu_torch.planner as tplanner
import metis_tpu_torch.profiles.store as tstore
from metis_tpu_torch import cli as tcli

torch.set_num_threads(1)

JAX = dict(cluster=jcluster, planner=jplanner, errors=jerrors, config=jconfig,
           store=jstore, mesh=jmesh)
PORT = dict(cluster=tcluster, planner=tplanner, errors=terrors, config=tconfig,
            store=tstore, mesh=tmesh)
REL = 1e-9


def _of(pkg, *nodes):
    return pkg["cluster"].ClusterSpec.of(*nodes)


def _topology(c):
    return ([(n.device_type, n.num_devices) for n in c.nodes], sorted(c.devices))


def _delta(d):
    return (d.added, d.removed, d.is_empty, d.num_added, d.num_removed)


# each case maps a package to a comparable outcome (or raises)
DELTA_CASES = {
    "between_lost_node": lambda p: _delta(p["planner"].ClusterDelta.between(
        _of(p, ("A100", 2, 4), ("T4", 2, 4)), _of(p, ("A100", 2, 4), ("T4", 1, 4)))),
    "between_both_ways": lambda p: _delta(p["planner"].ClusterDelta.between(
        _of(p, ("A100", 2, 4), ("T4", 1, 4)), _of(p, ("A100", 1, 4), ("T4", 3, 4)))),
    "between_type_swap": lambda p: _delta(p["planner"].ClusterDelta.between(
        _of(p, ("A100", 1, 4)), _of(p, ("T4", 1, 8)))),
    "between_regrouped": lambda p: _delta(p["planner"].ClusterDelta.between(
        _of(p, ("A100", 2, 4)), _of(p, ("A100", 4, 2)))),
    "shrink_whole_node": lambda p: _topology(p["planner"].shrink_cluster(
        _of(p, ("A100", 3, 4)), {"A100": 4})),
    "shrink_partial_node": lambda p: _topology(p["planner"].shrink_cluster(
        _of(p, ("A100", 2, 4)), {"A100": 2})),
    "shrink_one_type": lambda p: _topology(p["planner"].shrink_cluster(
        _of(p, ("A100", 2, 4), ("T4", 2, 4)), {"T4": 8})),
    "shrink_too_many": lambda p: p["planner"].shrink_cluster(
        _of(p, ("A100", 1, 4)), {"A100": 5}),
    "shrink_absent_type": lambda p: p["planner"].shrink_cluster(
        _of(p, ("A100", 1, 4)), {"T4": 1}),
    "shrink_nothing_left": lambda p: p["planner"].shrink_cluster(
        _of(p, ("A100", 1, 4)), {"A100": 4}),
    "shrink_zero": lambda p: p["planner"].shrink_cluster(
        _of(p, ("A100", 1, 4)), {"A100": 0}),
    "grow_whole_node": lambda p: _topology(p["planner"].grow_cluster(
        p["planner"].shrink_cluster(_of(p, ("A100", 3, 4)), {"A100": 4}),
        _of(p, ("A100", 3, 4)), {"A100": 4})),
    "grow_partial_return": lambda p: _topology(p["planner"].grow_cluster(
        p["planner"].shrink_cluster(_of(p, ("A100", 3, 4)), {"A100": 8}),
        _of(p, ("A100", 3, 4)), {"A100": 4})),
    "grow_round_trip": lambda p: _topology(p["planner"].grow_cluster(
        p["planner"].shrink_cluster(_of(p, ("A100", 2, 4), ("T4", 2, 4)),
                                    {"A100": 2, "T4": 4}),
        _of(p, ("A100", 2, 4), ("T4", 2, 4)), {"A100": 2, "T4": 4})),
    "grow_past_reference": lambda p: p["planner"].grow_cluster(
        _of(p, ("A100", 2, 4)), _of(p, ("A100", 2, 4)), {"A100": 4}),
    "grow_unknown_type": lambda p: p["planner"].grow_cluster(
        p["planner"].shrink_cluster(_of(p, ("A100", 2, 4)), {"A100": 4}),
        _of(p, ("A100", 2, 4)), {"H100": 4}),
    "grow_negative": lambda p: p["planner"].grow_cluster(
        _of(p, ("A100", 2, 4)), _of(p, ("A100", 2, 4)), {"A100": -1}),
    "apply_removed": lambda p: _topology(p["planner"].ClusterDelta(
        added={}, removed={"A100": 2, "T4": 8}).apply(
        _of(p, ("A100", 2, 4), ("T4", 2, 4)))),
    "apply_added_new_type": lambda p: _topology(p["planner"].ClusterDelta(
        added={"V100": 4}, removed={}).apply(_of(p, ("A100", 2, 4), ("T4", 2, 4)))),
    "apply_toward_full": lambda p: _topology(p["planner"].ClusterDelta(
        added={"A100": 4}, removed={}).apply(
        p["planner"].shrink_cluster(_of(p, ("A100", 2, 4)), {"A100": 4}),
        full=_of(p, ("A100", 2, 4)))),
    "apply_added_zero": lambda p: p["planner"].ClusterDelta(
        added={"T4": 0}, removed={}).apply(_of(p, ("A100", 1, 4))),
}


def _outcome(case, pkg):
    try:
        return ("ok", DELTA_CASES[case](pkg))
    except pkg["errors"].ClusterSpecError as e:
        return ("ClusterSpecError", str(e))


@pytest.mark.parametrize("case", sorted(DELTA_CASES))
def test_cluster_delta_arithmetic_matches_jax(case):
    want, got = _outcome(case, JAX), _outcome(case, PORT)
    assert got == want


@pytest.fixture(scope="module")
def profiles(tmp_path_factory):
    """The reference's replan fixture (``tests/test_replan.py``): the tiny
    planner-scale model, A100 and T4 profiles, read by both packages."""
    root = tmp_path_factory.mktemp("replan_profiles")
    synthesize_profiles(tiny_test_model(), ["A100", "T4"], tps=[1, 2, 4],
                        bss=[1, 2, 4, 8, 16]).dump_to_dir(root)
    return root


REPLAN_CASES = {
    "lost_node": ((("A100", 2, 4),), (("A100", 1, 4),), {}),
    "no_change": ((("A100", 2, 4),), (("A100", 2, 4),), {}),
    "added_capacity": ((("A100", 1, 4),), (("A100", 1, 4), ("T4", 1, 4)), {}),
    "lost_type_no_old_search": ((("A100", 1, 4), ("T4", 1, 4)), (("A100", 1, 4),),
                                dict(search_old=False)),
}


@pytest.mark.parametrize("case", sorted(REPLAN_CASES))
def test_replan_report_matches_jax(profiles, case):
    old, new, kw = REPLAN_CASES[case]
    reports = []
    for pkg in (JAX, PORT):
        model = pkg["config"].ModelSpec(**tiny_test_model().__dict__)
        reports.append(pkg["planner"].replan(
            _of(pkg, *old), _of(pkg, *new),
            pkg["store"].ProfileStore.from_dir(profiles), model,
            pkg["config"].SearchConfig(gbs=64), **kw))
    want, got = reports
    assert got.delta.added == want.delta.added
    assert got.delta.removed == want.delta.removed
    assert got.plan_changed == want.plan_changed
    for a, b in ((got.old_best_cost_ms, want.old_best_cost_ms),
                 (got.new_best_cost_ms, want.new_best_cost_ms),
                 (got.cost_ratio, want.cost_ratio)):
        assert (a is None) == (b is None)
        if b is not None:
            assert math.isclose(a, b, rel_tol=REL)
    assert got.result.best is not None
    assert (tmesh.PlanArtifact.from_ranked_plan(got.result.best).to_json()
            == jmesh.PlanArtifact.from_ranked_plan(want.result.best).to_json())


@pytest.fixture(scope="module")
def parity(tmp_path_factory):
    root = tmp_path_factory.mktemp("replan_parity")
    write_parity_fixture(root)
    # the survivor topology: one A100 node of four lost
    lines = (root / "hostfile").read_text().splitlines()
    (root / "hostfile.new").write_text("\n".join(lines[:-1]) + "\n")
    return root


@pytest.mark.parametrize("extra", [[], ["--no-old-cost"]], ids=["old_cost", "no_old_cost"])
def test_replan_cli_writes_the_same_bytes(parity, tmp_path, extra, capsys):
    outs, lines = [], []
    for name, main in (("jax", jcli.main), ("port", tcli.main)):
        out = tmp_path / f"{name}.json"
        capsys.readouterr()
        assert main([
            "replan", "--hostfile", str(parity / "hostfile"),
            "--clusterfile", str(parity / "clusterfile.json"),
            "--new-hostfile", str(parity / "hostfile.new"),
            "--new-clusterfile", str(parity / "clusterfile.json"),
            "--profile-dir", str(parity / "profiles"),
            "--num-layers", "10", "--hidden-size", "4096", "--seq-len", "1024",
            "--vocab-size", "51200", "--num-heads", "32",
            "--gbs", str(PARITY_GBS), "--max-tp", str(PARITY_MAX_TP),
            "--max-bs", str(PARITY_MAX_BS), "--top-k", "5",
            "--output", str(out), *extra]) == 0
        outs.append(out.read_bytes())
        lines.append(capsys.readouterr().err.strip().splitlines()[-1])
    assert outs[0] == outs[1]
    assert lines[0] == lines[1] and lines[1].startswith("replan: delta +{}")
    payload = json.loads(outs[1])
    assert payload["delta"] == {"added": {}, "removed": {"A100": 4}}
    assert len(payload["plans"]) == 5

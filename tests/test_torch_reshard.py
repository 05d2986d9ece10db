"""The port's live plan migration (``metis_tpu_torch/execution/reshard.py``)
against the JAX package's.

Analytic half: ``stage_layout``, ``layout_moved_bytes``,
``price_migration_ms``, ``device_sets_intersect`` and
``migration_eligible`` equal the reference's on the layouts of
``tests/test_migration.py``, and the moved bytes equal what the port's
estimator charges as its ``migration`` term.

Live half, on four gloo ranks (``testing.reshard_rank``): dp 2 x tp 2 at
ZeRO 1, trained two steps, resharded onto tp 2 on ranks 0-1 (ranks 2-3
only send) and onto dp 4; the one-device state is bit for bit the same
before and after (and verified), and the next two steps' losses equal, in
the trajectory tolerance, the reference's ``execute_reshard`` between the
same meshes on the virtual CPU mesh.  A tensor a rank already holds as the
destination wants it is not moved (onto the source plan itself nothing
moves); another model raises ``MigrationError``; an injected
``reshard_send`` is retried and an injected ``reshard_verify`` raises,
the source state untouched.
"""
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch

from metis_tpu.cluster import ClusterSpec as JClusterSpec
from metis_tpu.cost.volume import TransformerVolume as JVolume
from metis_tpu.execution import builder as jbuilder
from metis_tpu.execution import reshard as jreshard
from metis_tpu.execution.mesh import PlanArtifact as JPlanArtifact
from metis_tpu.profiles import synthesize_profiles, tiny_test_model
from metis_tpu_torch.cluster.spec import ClusterSpec as TClusterSpec
from metis_tpu_torch.core.config import ModelSpec
from metis_tpu_torch.cost.estimator import EstimatorOptions, HeteroCostEstimator
from metis_tpu_torch.cost.volume import TransformerVolume as TVolume
from metis_tpu_torch.execution import dist as tdist
from metis_tpu_torch.execution import reshard as treshard
from metis_tpu_torch.testing import reshard_rank
from tests.torch_elastic_reference import (
    SEED,
    SHAPE,
    TOL,
    batches,
    configs,
    gspmd,
    hetero,
    params,
    pipeline,
    torch_batches,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def volumes():
    model = tiny_test_model()
    store = synthesize_profiles(model, ["A100"], tps=[1, 2], bss=[1, 2, 4, 8])
    ppl = store.model.params_per_layer_bytes
    tmodel = ModelSpec(**{k: getattr(model, k) for k in (
        "name", "num_layers", "hidden_size", "sequence_length", "vocab_size",
        "num_heads")})
    return JVolume(model, ppl), TVolume(tmodel, ppl)


LAYOUTS = [  # tests/test_migration.py's, and more
    (((1, 0, 5), (1, 5, 10)), ((1, 0, 5), (1, 5, 10))),
    (((1, 0, 5), (1, 5, 10)), ((1, 0, 3), (1, 3, 10))),
    (((1, 0, 5), (1, 5, 10)), ((2, 0, 5), (1, 5, 10))),
    (((1, 0, 10),), ((2, 0, 10),)),
    (((2, 0, 4), (1, 4, 7), (2, 7, 10)), ((1, 0, 6), (2, 6, 10))),
]


@pytest.mark.parametrize("old,new", LAYOUTS)
def test_layout_pricing_equals_the_reference(volumes, old, new):
    jvol, tvol = volumes
    assert (treshard.layout_moved_bytes(old, new, tvol)
            == jreshard.layout_moved_bytes(old, new, jvol))
    for bw in (50.0, 100.0, 289.5):
        assert (treshard.price_migration_ms(old, new, tvol, bw)
                == jreshard.price_migration_ms(old, new, jvol, bw))
    # the port's estimator charges the same bytes as its migration term
    options = EstimatorOptions(migrate_from=old)
    est = object.__new__(HeteroCostEstimator)
    est.options, est.volume = options, tvol
    est._migration_cache, est._migrate_from_tp = {}, None
    tps = tuple(tp for tp, _, _ in new)
    partition = tuple(s for _, s, _ in new) + (new[-1][2],)
    moved = treshard.layout_moved_bytes(old, new, tvol)
    assert est._migration_ms(tps, partition) == pytest.approx(
        moved / options.bw_to_bytes_per_ms(options.migration_bw_gbps)
        / options.migration_amortize_steps, rel=1e-12)


@pytest.mark.parametrize("artifact", [
    gspmd(dp=2, tp=2), pipeline(2, 2), pipeline(4, 1),
    hetero((0, 3, 6), {"dp": 2, "tp": 1}, {"dp": 1, "tp": 2})],
    ids=["gspmd", "pipeline", "pipeline4", "hetero"])
def test_stage_layout_equals_the_reference(artifact):
    j = JPlanArtifact.from_json(artifact.to_json())
    n = SHAPE["num_blocks"] + 2
    assert treshard.stage_layout(artifact, n) == jreshard.stage_layout(j, n)


def test_eligibility_equals_the_reference():
    kinds = ("gspmd", "pipeline", "hetero")
    layouts = ("canonical", "interleaved:2x2")
    for a in kinds:
        for b in kinds:
            for la in layouts:
                for lb in layouts:
                    for alive in (True, False):
                        assert (treshard.migration_eligible(a, b, la, lb, alive)
                                == jreshard.migration_eligible(a, b, la, lb, alive))
    for old, new in [((("A100", 2, 4),), (("A100", 1, 4),)),
                     ((("A100", 2, 4),), (("T4", 2, 4),)),
                     ((("A100", 1, 4), ("T4", 1, 4)), (("T4", 1, 2),))]:
        assert (treshard.device_sets_intersect(TClusterSpec.of(*old),
                                               TClusterSpec.of(*new))
                == jreshard.device_sets_intersect(JClusterSpec.of(*old),
                                                  JClusterSpec.of(*new)))


SOURCE = gspmd(dp=2, tp=2, zero=1)
TARGETS = [gspmd(tp=2), gspmd(dp=4)]


def _reference(jcfg, arrays):
    """The reference's plan SOURCE two steps, ``execute_reshard`` onto each
    of TARGETS and two more steps: the losses after each."""
    exe = jbuilder.build_executable(jcfg, JPlanArtifact.from_json(SOURCE.to_json()))
    state = exe.init(jax.random.PRNGKey(SEED))
    for b in arrays[:2]:
        state, _ = exe.step(state, b[:, :-1], b[:, 1:])
    out = []
    for target in TARGETS:
        dst = jbuilder.build_executable(jcfg, JPlanArtifact.from_json(target.to_json()))
        new, report = jreshard.execute_reshard(
            state, dst.init(jax.random.PRNGKey(SEED + 1)))
        assert report.verified
        losses = []
        for b in arrays[2:]:
            new, loss = dst.step(new, b[:, :-1], b[:, 1:])
            losses.append(float(loss))
        out.append(losses)
    return out


@pytest.fixture(scope="module")
def live():
    jcfg, cfg = configs("gpt")
    other = configs("gpt")[1].__class__(**{**SHAPE, "num_blocks": 2},
                                        dtype=torch.float32)
    arrays = batches()
    with ThreadPoolExecutor(1) as pool:
        port = pool.submit(tdist.spawn, reshard_rank, 4, "gloo", ["cpu"] * 4,
                           cfg, params(jcfg), torch_batches(arrays),
                           SOURCE.to_json(), [t.to_json() for t in TARGETS], other)
        ref = _reference(jcfg, arrays)
        return port.result(), ref


@pytest.mark.parametrize("i", range(len(TARGETS)), ids=["tp2_on_two", "dp4"])
def test_live_reshard_is_bit_exact_and_trains_as_the_reference(live, i):
    ranks, ref = live
    for r in ranks:
        t = r["targets"][i]
        assert t["report"].verified
        assert t["digests"] == r["source_digests"]
        assert t["events"][0] == "reshard_plan"
        assert t["events"][-1] == "migration_complete"
        assert t["events"].count("reshard_step") == t["report"].moved
        assert len(t["moved"]) == t["report"].moved
        assert t["report"].moved_bytes > 0 and t["report"].stall_ms > 0
        # the stall's parts, each timed on rank 0 inside it
        phases = t["report"].phases_ms
        assert set(phases) == set(treshard.PHASES)
        assert all(v >= 0 for v in phases.values())
        assert sum(phases.values()) <= t["report"].stall_ms
    # the destination's ranks train on; tp 2 leaves ranks 2-3 out
    for r in ranks[:2] if i == 0 else ranks:
        np.testing.assert_allclose(r["targets"][i]["losses"], ref[i], **TOL)
    if i == 0:
        assert [r["targets"][0]["losses"] for r in ranks[2:]] == [[], []]


def test_resident_tensors_are_not_moved(live):
    ranks, _ = live
    for r in ranks:
        moved, total, moved_bytes = r["drills"]["resident"]
        assert (moved, moved_bytes) == ([], 0) and total > 0
        # onto tp 2 on ranks 0-1, which held dp replica 0's tp blocks,
        # every parameter is resident; the ZeRO 1 moments' flat chunks move
        onto_tp2, onto_dp4 = r["targets"][0]["moved"], r["targets"][1]["moved"]
        assert {what for _, what in onto_tp2} == {"exp_avg", "exp_avg_sq"}
        assert ("blocks/qkv", "exp_avg") in onto_tp2
        # onto dp 4 the tp-split parameters move, the whole ones stay
        assert ("blocks/qkv", "param") in onto_dp4
        assert ("embed/pos", "param") not in onto_dp4


def test_injected_faults(live):
    ranks, _ = live
    for r in ranks:
        d = r["drills"]
        assert d["send"]["report"].verified
        assert d["send"]["events"].count("retry_attempt") == 2
        assert "injected reshard_verify fault" in d["verify"]["error"]
        assert d["verify"]["error"].startswith("MigrationError")
        assert d["schema"]["error"].startswith("MigrationError")
        for name in ("verify", "schema"):
            assert d[name]["source_digests"] == r["source_digests"], name

"""The port's synthetic profiles (``metis_tpu_torch/profiles/synthetic.py``)
and parity fixtures (``metis_tpu_torch/fixtures.py``, re-exported by
``metis_tpu_torch.testing``) against the reference's
(``metis_tpu/profiles/synthetic.py``, ``metis_tpu/testing.py``).

The same model, device types, tps and bss go through both packages'
``synthesize_profiles``; their ``dump_to_dir`` directories must hold the
same files byte for byte (with and without decode tables, for the GPT test
model, an MoE and a GQA variant).  Every fixture writer's files are
byte-identical to the reference writer's, and the scale workload's cluster,
config and profiles equal the reference's."""
import dataclasses
import filecmp
from pathlib import Path

import pytest

import metis_tpu.profiles.synthetic as jsynth
import metis_tpu.testing as jtesting
import metis_tpu_torch.fixtures as tfixtures
import metis_tpu_torch.profiles.synthetic as tsynth
from metis_tpu.core.config import ModelSpec as JModelSpec
from metis_tpu_torch.core.config import ModelSpec as TModelSpec

TPS = [1, 2, 4]
BSS = [1, 2, 4, 8, 16]
# the reference's test model and two variants that take the other branches
# of the roofline (expert FFNs, a KV head count below the head count)
MODELS = {
    "tiny": {},
    "moe": dict(num_layers=6, num_experts=8, expert_top_k=2),
    "gqa": dict(num_layers=6, family="llama", num_kv_heads=8),
}


def _model(mod, name):
    base = dataclasses.asdict(jsynth.tiny_test_model())
    spec = JModelSpec if mod is jsynth else TModelSpec
    return spec(**{**base, **MODELS[name]})


def _same_tree(a: Path, b: Path) -> int:
    """Both directories hold the same files, byte for byte; their count."""
    files = sorted(str(p.relative_to(a)) for p in a.rglob("*") if p.is_file())
    assert files == sorted(str(p.relative_to(b)) for p in b.rglob("*") if p.is_file())
    match, mismatch, errors = filecmp.cmpfiles(a, b, files, shallow=False)
    assert mismatch == [] and errors == []
    return len(match)


def test_chip_perf_equals_reference():
    assert list(tsynth.CHIP_PERF) == list(jsynth.CHIP_PERF)
    for name, perf in jsynth.CHIP_PERF.items():
        assert dataclasses.asdict(tsynth.CHIP_PERF[name]) == dataclasses.asdict(perf)
        for bs, tp in ((1, 1), (4, 2), (16, 4)):
            assert tsynth.CHIP_PERF[name].mfu(bs, tp) == perf.mfu(bs, tp)


def test_tiny_test_model_equals_reference():
    for layers in (10, 4):
        assert (dataclasses.asdict(tsynth.tiny_test_model(layers))
                == dataclasses.asdict(jsynth.tiny_test_model(layers)))


@pytest.mark.parametrize("decode_context", [0, 640])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_dump_byte_identical(tmp_path, name, decode_context):
    types = ["A100", "T4", "tpu_v5e"]
    for mod, side in ((jsynth, "ref"), (tsynth, "port")):
        mod.synthesize_profiles(_model(mod, name), types, tps=TPS, bss=BSS,
                                decode_context=decode_context).dump_to_dir(
            tmp_path / side)
    assert _same_tree(tmp_path / "ref", tmp_path / "port") == len(types) * 15


def test_defaults_and_chip_perf_override(tmp_path):
    """Default tps/bss, and a caller's ``chip_perf`` map (the scale
    workload's clones)."""
    for mod, side in ((jsynth, "ref"), (tsynth, "port")):
        model = _model(mod, "tiny")
        mod.synthesize_profiles(model, ["V100", "tpu_v6e"]).dump_to_dir(
            tmp_path / side / "defaults")
        perf = {"X": mod.CHIP_PERF["P100"], "Y": mod.ChipPerf("Y", 100, 500, 24, 0.3)}
        mod.synthesize_profiles(model, ["X", "Y"], tps=[1, 2], bss=[2, 8],
                                chip_perf=perf).dump_to_dir(tmp_path / side / "perf")
    assert _same_tree(tmp_path / "ref", tmp_path / "port") == 24 + 8


def test_profiles_package_exports():
    import metis_tpu_torch.profiles as tprofiles

    for name in ("ChipPerf", "CHIP_PERF", "synthesize_profiles", "tiny_test_model"):
        assert getattr(tprofiles, name) is getattr(tsynth, name)
        assert name in tprofiles.__all__


# -- the fixture writers -----------------------------------------------------

WRITERS = ("write_parity_fixture", "write_decode_parity_fixture",
           "write_spot_parity_fixture")


@pytest.mark.parametrize("writer", WRITERS)
def test_fixture_writer_byte_identical(tmp_path, writer):
    getattr(jtesting, writer)(tmp_path / "ref")
    getattr(tfixtures, writer)(tmp_path / "port")
    assert _same_tree(tmp_path / "ref", tmp_path / "port") == 2 + 30


def test_constants_equal_reference():
    for name in ("PARITY_GBS", "PARITY_MAX_TP", "PARITY_MAX_BS", "PARITY_INFERENCE",
                 "PARITY_INFERENCE_PREFIX", "PARITY_DECODE_CONTEXT",
                 "PARITY_SPOT_RATE", "SCALE_DEVICES",
                 "SCALE_GBS"):
        assert getattr(tfixtures, name) == getattr(jtesting, name), name


def test_testing_reexports_the_writers():
    import metis_tpu_torch.testing as ttesting

    for name in (*WRITERS, "symmetric_scale_workload", "run_reference_planner",
                 "PARITY_GBS", "PARITY_INFERENCE"):
        assert getattr(ttesting, name) is getattr(tfixtures, name)


@pytest.mark.parametrize("kw", [{}, dict(total_devices=64, per_node=4, gbs=256)])
def test_symmetric_scale_workload_equals_reference(tmp_path, kw):
    ref = jtesting.symmetric_scale_workload(**kw)
    port = tfixtures.symmetric_scale_workload(**kw)
    (rc, rp, rm, rcfg), (pc, pp, pm, pcfg) = ref, port
    assert dataclasses.asdict(pc) == dataclasses.asdict(rc)
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(rcfg)
    assert dataclasses.asdict(pm) == dataclasses.asdict(rm)
    rp.dump_to_dir(tmp_path / "ref")
    pp.dump_to_dir(tmp_path / "port")
    assert _same_tree(tmp_path / "ref", tmp_path / "port") == 4 * 15


def test_symmetric_scale_workload_rejects_uneven_split():
    for mod in (jtesting, tfixtures):
        with pytest.raises(ValueError, match="multiple of 32"):
            mod.symmetric_scale_workload(total_devices=48)


def test_run_reference_planner_equals_reference(reference_root, tmp_path):
    """The upstream planner, run by both packages' runners on the parity
    fixture, records the same candidates (skips without the checkout)."""
    tfixtures.write_parity_fixture(tmp_path)
    ref = jtesting.run_reference_planner(tmp_path, reference_root)
    port = tfixtures.run_reference_planner(tmp_path, reference_root)
    assert port["costs"] == ref["costs"]

"""The port's calibration fits against the JAX package's, on the same inputs.

The pure half of ``cost/calibration.py`` is host arithmetic in both packages,
so every value and every byte must be the same: ``fit_samples`` and the
``CollectiveCalibration`` artifact, the ledger correction, the recovery
fit, the roofline transfer and the stores and plans it gives.
"""
import dataclasses
import json
import math

import pytest

import metis_tpu.cost.calibration as jcal
import metis_tpu.obs.ledger as jledger
import metis_tpu.planner.cli as jcli
import metis_tpu.profiles.store as jstore
import metis_tpu.resilience.supervisor as jsup
from metis_tpu.core.events import EventLog as JEventLog
from metis_tpu.testing import PARITY_GBS, PARITY_MAX_BS, PARITY_MAX_TP, write_parity_fixture
import metis_tpu_torch.cost as tcost
import metis_tpu_torch.cost.calibration as tcal
import metis_tpu_torch.obs.ledger as tledger
import metis_tpu_torch.profiles.store as tstore
import metis_tpu_torch.resilience.supervisor as tsup
from metis_tpu_torch import cli as tcli
from metis_tpu_torch.core.events import EventLog as TEventLog

PKGS = {"jax": (jcal, jledger, jsup, jstore, JEventLog, jcli.main),
        "port": (tcal, tledger, tsup, tstore, TEventLog, tcli.main)}

# tests/test_calibration.py's samples: t = 0.05 ms + nbytes / (10 GB/s), and
# one constant-time ppermute
SAMPLE_ROWS = ([("all_reduce", 8, nb, 0.05 + nb / 10e6) for nb in (1e5, 1e6, 1e7)]
               + [("ppermute", 4, 1000, 0.2)])


def _samples(cal):
    return [cal.CollectiveSample(*row) for row in SAMPLE_ROWS]


def _calibration(cal):
    return cal.CollectiveCalibration(
        platform="cpu", device_kind="cpu", group_size=8,
        fits=cal.fit_samples(_samples(cal)), samples=tuple(_samples(cal)))


def test_cost_package_exports_the_references_calibration_names():
    from metis_tpu import cost as jcost

    names = {n for n in jcost.__all__ if getattr(jcost, n).__module__ == jcal.__name__}
    assert names <= set(tcost.__all__)
    assert all(getattr(tcost, n).__module__ == tcal.__name__ for n in names)
    assert tcal.COLLECTIVES == jcal.COLLECTIVES
    assert tcal.TRANSFER_COMPUTE_MIX == jcal.TRANSFER_COMPUTE_MIX
    assert issubclass(tcal.CalibrationError, ValueError)


@pytest.mark.parametrize("collective", ["all_reduce", "ppermute"])
def test_fit_samples_equals_the_reference(collective):
    want = jcal.fit_samples(_samples(jcal))[collective]
    got = tcal.fit_samples(_samples(tcal))[collective]
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.effective_bw_gbps == want.effective_bw_gbps
            or math.isinf(got.effective_bw_gbps) and math.isinf(want.effective_bw_gbps))
    for nbytes in (0, 5000, 3e6):
        assert got.predict_ms(nbytes) == want.predict_ms(nbytes)
    if collective == "all_reduce":
        assert got.latency_ms == pytest.approx(0.05, rel=1e-6)
        assert got.effective_bw_gbps == pytest.approx(10.0, rel=1e-6)


def test_fit_samples_clamps_a_negative_slope_and_intercept():
    rows = [("all_gather", 2, 1000, 2.0), ("all_gather", 2, 2000, 1.0),
            ("all_to_all", 2, 1000, -0.5), ("all_to_all", 2, 3000, 0.5)]
    want = jcal.fit_samples([jcal.CollectiveSample(*r) for r in rows])
    got = tcal.fit_samples([tcal.CollectiveSample(*r) for r in rows])
    assert {k: dataclasses.asdict(v) for k, v in got.items()} == \
        {k: dataclasses.asdict(v) for k, v in want.items()}
    assert got["all_gather"].ms_per_byte == 0.0
    assert got["all_to_all"].latency_ms == 0.0


def test_dump_bytes_equal_and_each_package_loads_the_others(tmp_path):
    paths = {}
    for name, (cal, *_rest) in PKGS.items():
        paths[name] = tmp_path / f"{name}.json"
        _calibration(cal).dump(paths[name])
    assert paths["jax"].read_bytes() == paths["port"].read_bytes()
    for name, other in (("jax", "port"), ("port", "jax")):
        cal = PKGS[name][0]
        back = cal.CollectiveCalibration.load(paths[other])
        want = _calibration(cal)
        assert back == want and back.samples == want.samples
        assert back.to_json_dict() == json.loads(paths[name].read_text())


def test_with_correction_bw_and_latency_equal_the_reference():
    j, t = _calibration(jcal), _calibration(tcal)
    for name in ("all_reduce", "ppermute", "all_gather"):
        assert t.bw_gbps(name) == j.bw_gbps(name)
        assert t.latency_ms(name) == j.latency_ms(name)
    assert t.bw_gbps("all_gather") is None and t.latency_ms("all_gather") == 0.0
    jc, tc = j.with_correction(1.3), t.with_correction(1.3)
    assert tc.to_json_dict() == jc.to_json_dict()
    for nbytes in (500, 1000, 4000):
        assert tc.fits["all_reduce"].predict_ms(nbytes) == pytest.approx(
            1.3 * t.fits["all_reduce"].predict_ms(nbytes))
    with pytest.raises(ValueError, match="correction scale must be > 0"):
        t.with_correction(0.0)


def test_fit_ledger_correction_on_pairs():
    preds = [100.0, 200.0, 50.0, 400.0, 120.0]
    pairs = [(p, 1.3 * p * (1 + 0.01 * ((i % 3) - 1))) for i, p in enumerate(preds)]
    # NaN, inf, unmatched and non-positive measurements are skipped
    noisy = pairs + [(float("nan"), 10.0), (10.0, float("inf")), (None, 5.0),
                     (10.0, 0.0)]
    got = tcal.fit_ledger_correction(noisy)
    assert got == jcal.fit_ledger_correction(noisy)
    assert got["n"] == 5 and got["scale"] == pytest.approx(1.3, rel=0.02)
    assert got["mape_after_pct"] < 1.5


def test_fit_ledger_correction_on_both_ledgers_samples(tmp_path):
    """One JSONL ledger, read back by each package's ``AccuracyLedger``: the
    same fit from either's samples, the unmatched and NaN rows skipped."""
    path = tmp_path / "ledger.jsonl"
    with tledger.AccuracyLedger(path) as led:
        for i, (p, m) in enumerate(((100.0, 120.0), (200.0, 230.0), (50.0, 70.0))):
            led.record_prediction(f"fp{i}", p)
            led.record_measurement(f"fp{i}", m, source="validate")
        led.record_measurement("unpredicted", 50.0)
        led.record_prediction("nan_measured", 10.0)
    with open(path, "a") as f:
        f.write(json.dumps({"kind": "measurement", "fingerprint": "nan_measured",
                            "measured_ms": float("nan")}) + "\n")
    fits = [cal.fit_ledger_correction(ledger.AccuracyLedger(path).samples)
            for cal, ledger, *_ in PKGS.values()]
    assert fits[0] == fits[1] and fits[1]["n"] == 3
    assert fits[1]["scale"] == pytest.approx(
        (100 * 120 + 200 * 230 + 50 * 70) / (100**2 + 200**2 + 50**2), abs=1e-6)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_fit_ledger_correction_empty_raises(pkg):
    cal, ledger = PKGS[pkg][0], PKGS[pkg][1]
    for samples in ([], ledger.AccuracyLedger(None).samples,
                    [(None, 3.0), (float("nan"), 1.0)]):
        with pytest.raises(cal.CalibrationError, match="no matched"):
            cal.fit_ledger_correction(samples)


RECOVERIES = [("device_loss", 23.4484), ("anomaly_rollback", 0.5),
              ("spot_preemption", 31.0), ("spot_return", 12.25),
              ("device_loss", 0.0), ("device_loss", 40.5)]


def _records(sup):
    return [sup.RecoveryRecord(kind=k, step=4, resumed_step=4, recover_s=s)
            for k, s in RECOVERIES]


@pytest.mark.parametrize("form", ["floats", "pairs", "dicts", "records_jax",
                                  "records_port"])
def test_fit_recovery_seconds_equals_the_reference(form):
    samples = {
        "floats": [s for _, s in RECOVERIES],
        "pairs": list(RECOVERIES),
        "dicts": [{"kind": k, "recover_s": s} for k, s in RECOVERIES],
        "records_jax": _records(jsup),
        "records_port": _records(tsup),
    }[form]
    for kinds in (None, ("device_loss",), ("anomaly_rollback",)):
        got = tcal.fit_recovery_seconds(samples, kinds)
        assert got == jcal.fit_recovery_seconds(samples, kinds)
    got = tcal.fit_recovery_seconds(samples)
    # the kinds filter drops the rollback where a sample carries a kind
    assert got["n"] == (5 if form == "floats" else 4)
    assert got["spot_recover_s"] == got["p50_s"]


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_fit_recovery_seconds_empty_raises(pkg):
    cal = PKGS[pkg][0]
    for samples in ([], [0.0, -1.0], [("anomaly_rollback", 3.0)]):
        with pytest.raises(ValueError, match="no usable recovery samples"):
            cal.fit_recovery_seconds(samples)


def test_fit_transfer_scale_equals_the_reference():
    src = {"matmul_tflops": 312.0, "hbm_stream_gbps": 2039.0, "device_kind": "A100"}
    tgt = {"matmul_tflops": 65.0, "hbm_stream_gbps": 320.0, "device_kind": "T4"}
    for mix in (0.0, 0.7, 1.0):
        got = tcal.fit_transfer_scale(src, tgt, compute_mix=mix)
        assert got == jcal.fit_transfer_scale(src, tgt, compute_mix=mix)
    assert tcal.fit_transfer_scale(src, dict(src))["time_scale"] == pytest.approx(1.0)


@pytest.mark.parametrize("bad", [
    {}, {"matmul_tflops": 0.0, "hbm_stream_gbps": 100.0},
    {"matmul_tflops": 100.0, "hbm_stream_gbps": -1.0},
    {"matmul_tflops": "fast", "hbm_stream_gbps": 1.0}],
    ids=["missing", "zero_tflops", "negative_gbps", "not_a_number"])
def test_fit_transfer_scale_errors(bad):
    good = {"matmul_tflops": 312.0, "hbm_stream_gbps": 2039.0}
    for args, kw in (((good, bad), {}), ((bad, good), {}),
                     ((good, good), {"compute_mix": 1.5})):
        with pytest.raises(tcal.CalibrationError) as got:
            tcal.fit_transfer_scale(*args, **kw)
        with pytest.raises(jcal.CalibrationError) as want:
            jcal.fit_transfer_scale(*args, **kw)
        assert str(got.value) == str(want.value)


SCALES = {"compute_scale": 0.208333, "mem_scale": 0.156940, "time_scale": 5.271636}


@pytest.fixture(scope="module")
def transferred(tmp_path_factory):
    """Each package's store of the parity fixture's A100 entries alone,
    transferred to T4 (the type the fixture's cluster also holds), dumped
    to a profile dir of its own, with its ``transfer_fit`` events."""
    root = tmp_path_factory.mktemp("transfer")
    write_parity_fixture(root / "parity")
    out = {"root": root}
    for name, (cal, _l, _s, store_mod, EventLog, _m) in PKGS.items():
        full = store_mod.ProfileStore.from_dir(root / "parity" / "profiles")
        a100 = store_mod.ProfileStore(
            {k: full.get(*k) for k in full.configs("A100")}, full.model,
            {"A100": full.type_meta["A100"]})
        a100.attn = full.attn
        events = root / f"{name}.events.jsonl"
        merged = cal.transfer_profiles(a100, "A100", "T4", SCALES,
                                       events=EventLog(events))
        merged.dump_to_dir(root / f"{name}_profiles")
        out[name] = dict(store=merged, source=a100, events=[
            json.loads(line) for line in events.read_text().splitlines()])
    return out


def test_transfer_profiles_dump_the_same_bytes(transferred):
    root = transferred["root"]
    files = {name: sorted((root / f"{name}_profiles").iterdir())
             for name in ("jax", "port")}
    assert [f.name for f in files["jax"]] == [f.name for f in files["port"]]
    assert any("T4" in f.name for f in files["port"])
    for j, t in zip(files["jax"], files["port"]):
        assert t.read_bytes() == j.read_bytes(), t.name


def test_transfer_profiles_provenance_and_event(transferred):
    j, t = transferred["jax"], transferred["port"]
    assert t["store"].transferred == j["store"].transferred
    assert t["store"].transferred["T4"] == {"source": "A100", "transferred": True,
                                            **SCALES}
    assert not t["source"].transferred  # the source store is untouched
    strip = [{k: v for k, v in e.items() if k != "ts"} for e in j["events"]]
    assert [{k: v for k, v in e.items() if k != "ts"} for e in t["events"]] == strip
    assert strip == [{"event": "transfer_fit", "source_type": "A100",
                      "target_type": "T4", "time_scale": SCALES["time_scale"],
                      "compute_scale": SCALES["compute_scale"],
                      "mem_scale": SCALES["mem_scale"],
                      "n_entries": len(t["source"].configs("A100"))}]
    src, got = t["source"].get("A100", 1, 2), t["store"].get("T4", 1, 2)
    assert got.layer_memory_mb == src.layer_memory_mb
    assert got.layer_times_ms == pytest.approx(
        tuple(x * SCALES["time_scale"] for x in src.layer_times_ms))


def test_transfer_profiles_errors(transferred):
    root = transferred["root"]
    msgs = {}
    for name, (cal, _l, _s, store_mod, _e, _m) in PKGS.items():
        store = store_mod.ProfileStore.from_dir(root / "parity" / "profiles")
        msgs[name] = []
        for src, tgt, scales in (("H100", "B200", SCALES), ("A100", "T4", SCALES),
                                 ("A100", "H100", {"time_scale": 0.0})):
            with pytest.raises(cal.CalibrationError) as e:
                cal.transfer_profiles(store, src, tgt, scales)
            msgs[name].append(str(e.value))
    assert msgs["port"] == msgs["jax"]


def test_hetero_cli_on_transferred_profiles_writes_the_same_bytes(transferred, tmp_path):
    root = transferred["root"]
    outs = []
    for name in ("jax", "port"):
        out = tmp_path / f"{name}.json"
        assert PKGS[name][5]([
            "hetero", "--hostfile", str(root / "parity" / "hostfile"),
            "--clusterfile", str(root / "parity" / "clusterfile.json"),
            "--profile-dir", str(root / f"{name}_profiles"),
            "--num-layers", "10", "--hidden-size", "4096", "--seq-len", "1024",
            "--vocab-size", "51200", "--num-heads", "32",
            "--gbs", str(PARITY_GBS), "--max-tp", str(PARITY_MAX_TP),
            "--max-bs", str(PARITY_MAX_BS), "--top-k", "10",
            "--output", str(out)]) == 0
        outs.append(out.read_bytes())
    plans = json.loads(outs[1])
    assert outs[0] == outs[1] and plans
    # the cluster's T4 nodes run on the transferred profiles
    assert any("T4" in json.dumps(p) for p in plans)

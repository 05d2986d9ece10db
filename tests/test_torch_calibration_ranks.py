"""The port's calibration measurements on gloo CPU ranks, against the
JAX package's on the virtual CPU devices.

Each measurement runs one rank per device over ``torch.distributed`` (a
rank pool of 2 and one of 4); the reference runs the same function over
the first n of the 8 virtual CPU devices.  Times on a shared host are noise,
so no test asserts a time beyond finite and non-negative: the tests hold the
shape of each result (its keys, the logical payloads, ``grad_bytes``, the
event's fields), the fits, the noise cap and the losses.
"""
import argparse
import io
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metis_tpu.cost.calibration as jcal
import metis_tpu.planner.cli as jcli
from metis_tpu.core.events import EventLog as JEventLog
import metis_tpu_torch.cost.calibration as tcal
from metis_tpu_torch import cli as tcli
from metis_tpu_torch.execution import dist as tdist

torch.set_num_threads(1)

PAYLOAD_KB = (16, 64)
DP_SHAPE = dict(hidden=64, layers=3, batch_per_device=4, iters=3, warmup=1)
PIPE_SHAPE = dict(microbatches=2, hidden=16, blocks=2, seq=8, vocab=64, iters=2,
                  warmup=1)


@pytest.fixture(scope="module")
def runs():
    """Every rank job of the file, on one pool of 2 and one of 4 gloo
    ranks."""
    out = {}
    with tdist.RankPool(2, "gloo", ["cpu"] * 2) as pool:
        out["collectives_2"] = pool.run(tcal.measure_rank, "microbenchmark_collectives",
                                        dict(payload_kb=PAYLOAD_KB, iters=2))
        out["dp"] = pool.run(tcal.measure_rank, "measure_dp_overlap", DP_SHAPE)
    with tdist.RankPool(4, "gloo", ["cpu"] * 4) as pool:
        out["collectives_4"] = pool.run(tcal.measure_rank, "microbenchmark_collectives",
                                        dict(payload_kb=PAYLOAD_KB, iters=2))
        out["pipe"] = pool.run(tcal.measure_rank, "measure_pipeline_overlap", PIPE_SHAPE)
    return out


@pytest.mark.parametrize("n", [2, 4])
def test_collectives_match_the_reference(runs, n):
    ranks = runs[f"collectives_{n}"]
    assert all(r["result"] == ranks[0]["result"] for r in ranks)  # rank 0's on every rank
    got = ranks[0]["result"].to_json_dict()
    want = jcal.microbenchmark_collectives(
        jax.devices("cpu")[:n], payload_kb=PAYLOAD_KB, iters=1, warmup=1)
    key = lambda s: (s["collective"], s["group_size"], s["nbytes"])  # noqa: E731
    assert sorted(map(key, got["samples"])) == sorted(
        map(key, want.to_json_dict()["samples"]))
    assert (got["platform"], got["device_kind"], got["group_size"]) == ("cpu", "cpu", n)
    assert set(got["fits"]) == set(tcal.COLLECTIVES)
    for name, fit in got["fits"].items():
        assert fit["n_samples"] == len(PAYLOAD_KB)
        assert fit["latency_ms"] >= 0 and fit["ms_per_byte"] >= 0
    assert all(math.isfinite(s["time_ms"]) and s["time_ms"] > 0 for s in got["samples"])
    # the reference's artifact type reads the port's JSON, and back
    loaded = jcal.CollectiveCalibration.from_json_dict(json.loads(json.dumps(got)))
    assert loaded.to_json_dict() == tcal.CollectiveCalibration.from_json_dict(
        got).to_json_dict()


def test_dp_overlap_matches_the_reference(runs):
    got = runs["dp"][0]["result"]
    assert all(r["result"] == got for r in runs["dp"])
    want = jcal.measure_dp_overlap(jax.devices("cpu")[:2], **DP_SHAPE)
    assert list(got) == list(want)
    assert got["grad_bytes"] == want["grad_bytes"] and got["group_size"] == 2
    assert 0.0 <= got["overlap_fraction"] <= 1.0
    assert got["bare_allreduce_ms"] > 0 and got["with_reduce_iqr_ms"] >= 0
    assert got["exposed_comm_ms"] == pytest.approx(
        max(got["with_reduce_ms"] - got["without_reduce_ms"], 0.0), abs=1e-3)
    if got["noise_limited"]:
        assert got["overlap_fraction"] <= 0.9


def test_dp_overlap_noise_cap(monkeypatch):
    """Timings whose exposure does not stand above their spread read
    ``noise_limited`` and the fraction stays at most 0.9, even where the
    step with the reduction ran faster than the one without it."""
    times = iter([(5.0, 2.0), (6.0, 2.0), (10.0, 0.1)])
    monkeypatch.setattr(tcal, "_timed", lambda *a, **k: next(times))
    # the measurement imports torch.distributed when it runs
    monkeypatch.setattr(torch.distributed, "get_world_size",
                        lambda group=None: 2)
    monkeypatch.setattr(torch.distributed, "barrier", lambda group=None: None)
    monkeypatch.setattr(tcal, "_rank0", lambda value: value)
    out = tcal.measure_dp_overlap("cpu", **DP_SHAPE)
    assert out["exposed_comm_ms"] == 0.0 and out["noise_limited"] is True
    assert out["overlap_fraction"] == 0.9


def test_pipeline_overlap_matches_the_reference(runs):
    ranks = runs["pipe"]
    got = ranks[0]["result"]
    assert all(r["result"] == got for r in ranks)
    buf = io.StringIO()
    want = jcal.measure_pipeline_overlap(jax.devices("cpu")[:4], pp=2, dp=2,
                                         events=JEventLog(stream=buf), **PIPE_SHAPE)
    assert list(got) == list(want)
    for k in ("pp", "dp", "microbatches", "schedule", "platform"):
        assert got[k] == want[k]
    assert 0.0 <= got["overlap_hidden_frac"] <= 1.0
    assert got["bare_comm_ms"] > 0 and got["lockstep_ms"] > 0 and got["overlapped_ms"] > 0
    assert got["saved_ms"] == pytest.approx(got["lockstep_ms"] - got["overlapped_ms"],
                                            abs=1e-3)
    # one overlap_measured event, on rank 0, with the reference's fields
    (want_ev,) = [json.loads(line) for line in buf.getvalue().splitlines()]
    assert [r["events"] for r in ranks[1:]] == [[]] * 3
    (ev,) = ranks[0]["events"]
    assert sorted(ev) == sorted(want_ev) and ev["event"] == "overlap_measured"
    assert ev["overlap_hidden_frac"] == got["overlap_hidden_frac"]
    # both modes take the same steps from the same state: the same losses
    steps = PIPE_SHAPE["iters"] + PIPE_SHAPE["warmup"]
    for r in ranks:
        assert len(r["losses"]["lockstep"]) == steps
        assert r["losses"]["overlapped"] == r["losses"]["lockstep"]
        assert all(math.isfinite(x) for x in r["losses"]["lockstep"])


def test_microbenchmark_chip_on_the_host():
    got = tcal.microbenchmark_chip(device="cpu", iters=1)
    assert set(got) == {"platform", "device_kind", "matmul_tflops", "hbm_stream_gbps"}
    assert (got["platform"], got["device_kind"]) == ("cpu", "cpu")
    assert got["matmul_tflops"] >= 0 and got["hbm_stream_gbps"] > 0


def test_matmul_chain_equals_the_references():
    """The compute chain of ``microbenchmark_chip`` at k 64 on random bf16
    inputs, against the reference's ``fori_loop`` body on the same inputs:
    within bf16 rounding (one ulp of 2^-8 per product, three products)."""
    k, n = 64, 3
    rng = np.random.default_rng(0)
    a = rng.standard_normal((k, k)).astype(np.float32)
    b = rng.standard_normal((k, k)).astype(np.float32)
    ja, jb = jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16)
    want = jax.lax.fori_loop(
        0, n, lambda _, x: ((x @ jb) * (1.0 / k)).astype(x.dtype), ja)
    got = tcal.matmul_chain(n, torch.from_numpy(a).bfloat16(),
                            torch.from_numpy(b).bfloat16())
    want = np.asarray(want.astype(jnp.float32))
    got = got.float().numpy()
    assert got.dtype == want.dtype and got.shape == (k, k)
    np.testing.assert_allclose(got, want, rtol=3e-2, atol=3e-2 * np.abs(want).max())
    stream = tcal.stream_chain(3, torch.ones(16))
    assert torch.equal(stream, torch.ones(16) * 1.0000001 * 1.0000001 * 1.0000001)


def test_calibrate_one_device_writes_nothing(tmp_path, capsys):
    out = tmp_path / "cal.json"
    assert tcli.main(["calibrate", "--output", str(out), "--device", "cpu"]) == 1
    assert not out.exists()
    assert capsys.readouterr().err.strip() == (
        "1 device visible: cannot calibrate collectives (needs >= 2); "
        f"{out} NOT written")


def test_calibrate_two_cpu_ranks(tmp_path, capsys):
    out = tmp_path / "cal.json"
    assert tcli.main(["calibrate", "--output", str(out), "--devices", "cpu,cpu",
                      "--payload-kb", "16,64", "--iters", "2",
                      "--chip-roofline"]) == 0
    err = capsys.readouterr().err
    assert f"calibrated 5 collectives over 2 cpu devices -> {out}" in err
    for cal in (jcal, tcal):
        loaded = cal.CollectiveCalibration.load(out)
        assert loaded.group_size == 2 and set(loaded.fits) == set(tcal.COLLECTIVES)
        assert all(f.n_samples == 2 for f in loaded.fits.values())
    chip = json.loads((tmp_path / "cal.json.chip.json").read_text())
    assert set(chip) == {"platform", "device_kind", "matmul_tflops", "hbm_stream_gbps"}


def _flags(main_parser, command):
    sub = next(a for a in main_parser._actions if a.dest == "command")
    return {opt: (a.default, a.required) for a in sub.choices[command]._actions
            for opt in a.option_strings if opt not in ("-h", "--help")}


def _reference_parser(monkeypatch):
    """The reference CLI's parser (its ``main`` builds it, then parses)."""
    class Built(Exception):
        pass

    def stop(self, *args, **kwargs):
        raise Built(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", stop)
    with pytest.raises(Built) as built:
        jcli.main(["calibrate", "--output", "unused"])
    monkeypatch.undo()
    return built.value.args[0]


def test_calibrate_flags_equal_the_references(monkeypatch):
    """The reference's flags with its defaults; its JAX backend pin
    (``--platform``, ``--virtual-devices``) becomes the port's ``--device``
    and, one rank per device, ``--devices`` and ``--dist-backend``, as
    ``train`` takes them."""
    want = _flags(_reference_parser(monkeypatch), "calibrate")
    got = _flags(tcli._parser(), "calibrate")
    for opt in ("--platform", "--virtual-devices"):
        want.pop(opt)
    assert {k: v for k, v in got.items()
            if k not in ("--device", "--devices", "--dist-backend")} == want
    assert got["--device"] == ("cuda", False) and got["--devices"] == (None, False)

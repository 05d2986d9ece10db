"""The port's ``plan`` and ``explain`` subcommands against the JAX
package's CLI (``metis_tpu.planner.cli``): the same arguments on the parity
fixtures of ``metis_tpu.testing`` print the same bytes — the serving
search's dump (``--workload inference``, with and without measured decode
tables and prefix sharing), the hetero search's, and both ``explain``
tables, as text and as JSON.  ``plan --remote`` asks a running daemon: its
stdout is the in-process ``plan``'s bytes, and against an unreachable
address it fails as the reference CLI fails.
"""
import contextlib
import io
import json

import pytest

from metis_tpu.planner import cli as jcli
from metis_tpu.testing import (
    PARITY_GBS,
    PARITY_INFERENCE,
    PARITY_INFERENCE_PREFIX,
    PARITY_MAX_BS,
    PARITY_MAX_TP,
    write_decode_parity_fixture,
    write_parity_fixture,
)
from metis_tpu_torch import cli as tcli

FLAGS = {"arrival_rate_rps": "--arrival-rate", "prompt_len": "--prompt-len",
         "output_len": "--output-len", "slo_ttft_p99_ms": "--slo-ttft",
         "slo_tpot_p99_ms": "--slo-tpot",
         "prefix_share_frac": "--prefix-share-frac",
         "prefix_len": "--prefix-len", "page_tokens": "--page-tokens"}


def _workload_flags(spec: dict) -> list[str]:
    return ["--workload", "inference",
            *(a for k, v in spec.items() for a in (FLAGS[k], str(v)))]


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    root = tmp_path_factory.mktemp("plan_cli")
    write_parity_fixture(root / "parity")
    write_decode_parity_fixture(root / "decode")
    return root


def _args(fixture_dir, command: str) -> list[str]:
    return [command, "--hostfile", str(fixture_dir / "hostfile"),
            "--clusterfile", str(fixture_dir / "clusterfile.json"),
            "--profile-dir", str(fixture_dir / "profiles"),
            "--num-layers", "10", "--hidden-size", "4096", "--seq-len", "1024",
            "--vocab-size", "51200", "--num-heads", "32",
            "--gbs", str(PARITY_GBS), "--max-tp", str(PARITY_MAX_TP),
            "--max-bs", str(PARITY_MAX_BS), "--top-k", "5"]


def _run(main, argv: list[str]) -> tuple[int, str, str]:
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


CASES = {
    "plan-inference": ("parity", "plan", _workload_flags(PARITY_INFERENCE)),
    "plan-inference-decode-prefix": (
        "decode", "plan", _workload_flags(PARITY_INFERENCE_PREFIX)),
    "plan-training": ("parity", "plan", []),
    "explain-training": ("parity", "explain", []),
    "explain-training-json": ("parity", "explain", ["--json"]),
    "explain-training-one-rank": ("parity", "explain", ["--ranks", "2"]),
    "explain-inference": ("parity", "explain",
                          _workload_flags(PARITY_INFERENCE)),
    "explain-inference-decode-prefix": (
        "decode", "explain", _workload_flags(PARITY_INFERENCE_PREFIX)),
    "explain-inference-json": (
        "decode", "explain",
        _workload_flags(PARITY_INFERENCE_PREFIX) + ["--json"]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_prints_the_reference_bytes(fixtures, case):
    fixture, command, extra = CASES[case]
    argv = _args(fixtures / fixture, command) + extra
    jrc, jout, jerr = _run(jcli.main, argv)
    trc, tout, terr = _run(tcli.main, argv)
    assert trc == jrc == 0
    assert tout == jout and len(tout) > 100
    if "inference" in case:  # the training searches print their seconds
        assert terr == jerr
    if case == "plan-inference-decode-prefix":
        assert '"decode_source": "measured"' in tout
    if case == "explain-inference-json":
        assert json.loads(tout)["kv_sharing"]["kv_reduction_frac"] > 0


@pytest.mark.parametrize("extra", [["--ranks", "x"], ["--ranks", "1,2,3"]],
                         ids=["not-int", "three"])
def test_explain_refuses_bad_ranks_as_the_reference(fixtures, extra):
    argv = (_args(fixtures / "parity", "explain")
            + _workload_flags(PARITY_INFERENCE) + extra)
    jrc, _, jerr = _run(jcli.main, argv)
    trc, _, terr = _run(tcli.main, argv)
    assert trc == jrc == 2 and terr == jerr


def _raised(main, argv: list[str]) -> tuple[str, str, str, str]:
    """(exception type, message, stdout, stderr) of a CLI call that
    raises — how both CLIs end on an unreachable daemon (rc 1 and the
    traceback's last line as a process)."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err), \
            pytest.raises(Exception) as e:
        main(argv)
    return (type(e.value).__name__, str(e.value), out.getvalue(),
            err.getvalue())


def test_plan_needs_its_inputs_or_a_daemon(fixtures):
    bare = ["plan", "--model-size", "1.5B", "--gbs", "8"]
    jrc, _, jerr = _run(jcli.main, bare)
    trc, _, terr = _run(tcli.main, bare)
    assert trc == jrc == 2 and terr == jerr
    # an unreachable daemon: the reference CLI's error, nothing printed
    argv = (_args(fixtures / "parity", "plan")
            + ["--remote", "unix:/nonexistent.sock"])
    got, want = _raised(tcli.main, argv), _raised(jcli.main, argv)
    assert got == want
    assert got[0] == "ServeClientError" and got[2:] == ("", "")


def test_plan_remote_against_a_live_daemon(fixtures):
    """``plan --remote`` of the port, and of the reference CLI, against a
    port daemon on the parity files: the in-process ``plan``'s stdout
    bytes, a cold search then a cache hit (training and serving
    queries)."""
    from metis_tpu_torch.cluster.spec import ClusterSpec
    from metis_tpu_torch.profiles.store import ProfileStore
    from metis_tpu_torch.serve.daemon import PlanService, serve_in_thread

    root = fixtures / "parity"
    service = PlanService(
        ClusterSpec.from_files(root / "hostfile", root / "clusterfile.json"),
        ProfileStore.from_dir(root / "profiles"))
    server, thread, address = serve_in_thread(service)
    try:
        for extra in ([], _workload_flags(PARITY_INFERENCE)):
            argv = _args(root, "plan") + extra
            _, local, _ = _run(tcli.main, argv)
            remote = argv + ["--remote", address]
            trc, tout, terr = _run(tcli.main, remote)
            jrc, jout, jerr = _run(jcli.main, remote)
            assert trc == jrc == 0
            assert tout == jout == local and len(local) > 100
            assert terr.startswith("cold search fingerprint=")
            assert jerr.startswith("cache hit fingerprint=")
            assert terr.split(" costed")[0].split("=")[1] == \
                jerr.split(" costed")[0].split("=")[1]
    finally:
        server.shutdown()
        thread.join(10)
        server.server_close()


def test_bad_workload_exits_with_the_reference_message(fixtures):
    argv = _args(fixtures / "parity", "plan") + ["--workload", "inference",
                                                 "--arrival-rate", "4"]
    messages = []
    for main in (jcli.main, tcli.main):
        with pytest.raises(SystemExit) as exc:
            _run(main, argv)
        messages.append(str(exc.value))
    assert messages[0] == messages[1]
    assert messages[1].startswith("bad inference workload")

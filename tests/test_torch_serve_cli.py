"""Port parity: the serving entry point ``repro_torch.launch.serve`` against
``repro.launch.serve`` on the same arguments.

With the simulated workloads every line but the mesh line's device name
is a function of the arguments and the seed, so the two packages print
the same D&A, report, cache and mutation lines. The PPR workload times
real FORA queries, so there the lines that do not depend on a measured
time are equal and the rest must carry the same labels. Without a card,
the default ``--device cuda`` raises instead of running on the CPU."""

from __future__ import annotations

import json

import pytest
import torch

from repro.launch import serve as jserve
from repro_torch.kernels import autotune
from repro_torch.launch import serve as tserve


@pytest.fixture(autouse=True)
def _cold_cache():
    autotune.clear_cache()
    yield
    autotune.clear_cache()


def _lines(main, argv, capsys) -> list[str]:
    capsys.readouterr()
    main(argv)
    return capsys.readouterr().out.splitlines()


def _both(argv, capsys, tmp_path=None):
    got = _lines(tserve.main, argv + ["--device", "cpu"], capsys)
    want = _lines(jserve.main, argv + ["--platform", "cpu"], capsys)
    return got, want


def _strip_mesh(lines):
    return [line.split(" on ")[0] if "cores->mesh" in line else line
            for line in lines]


SIM = [
    ["--workload", "lm-decode", "--queries", "256", "--deadline", "4"],
    ["--workload", "din-serve", "--queries", "512", "--deadline", "3",
     "--max-lanes", "8", "--step-time", "0.02", "--cv", "0.5"],
    ["--workload", "lm-decode", "--daemon", "--num-jobs", "6",
     "--arrival-rate", "0.8", "--queries", "120", "--deadline", "6",
     "--max-cores", "16"],
    ["--workload", "lm-decode", "--daemon", "--no-engine", "--num-jobs",
     "6", "--queries", "120", "--deadline", "6", "--max-cores", "16",
     "--stragglers", "--spares-fraction", "0.2"],
    ["--workload", "din-serve", "--daemon", "--num-jobs", "5",
     "--queries", "80", "--deadline", "5", "--max-cores", "12",
     "--cache-size", "256", "--mutation-rate", "1.5", "--mutations", "4",
     "--cache-ttl-factor", "3", "--chaos", "seed=7,failures=1,slowdowns=2"],
    ["--workload", "lm-decode", "--daemon", "--num-jobs", "4",
     "--queries", "60", "--deadline", "5", "--cold-compile", "2.5",
     "--warm-start"],
]


@pytest.mark.parametrize("argv", SIM, ids=lambda a: "_".join(
    x.lstrip("-") for x in a[:4]))
def test_sim_workloads_print_what_jax_prints(argv, capsys):
    got, want = _both(argv, capsys)
    assert len(got) >= 4
    assert _strip_mesh(got) == _strip_mesh(want)


def test_daemon_wal_recover_and_trace_print_what_jax_prints(tmp_path,
                                                            capsys):
    base = ["--workload", "lm-decode", "--daemon", "--num-jobs", "4",
            "--queries", "60", "--deadline", "5", "--max-cores", "8",
            "--snapshot-every", "10"]
    out = {}
    for name, main, flag in (("torch", tserve.main, ["--device", "cpu"]),
                             ("jax", jserve.main, ["--platform", "cpu"])):
        wal, trace = tmp_path / f"{name}_wal", tmp_path / f"{name}.json"
        crash = _lines(main, base + flag + [
            "--wal-dir", str(wal), "--record-trace", str(trace),
            "--chaos", "seed=3,crashes=2,crash_span=30"], capsys)
        rec = _lines(main, base + flag + ["--wal-dir", str(wal),
                                          "--recover"], capsys)
        out[name] = (crash, rec, json.loads(trace.read_text()))
    t, j = out["torch"], out["jax"]
    assert [line.replace(str(tmp_path / "torch"), "X")
            for line in t[0]] == [line.replace(str(tmp_path / "jax"), "X")
                                  for line in j[0]]
    assert [line.replace(str(tmp_path / "torch"), "X")
            for line in t[1]] == [line.replace(str(tmp_path / "jax"), "X")
                                  for line in j[1]]
    assert t[2] == j[2] and len(t[2]) == 4
    assert any("2 recoveries" in line for line in t[0])


def _labels(lines):
    """Each line's label; the occupancy rows' count follows the measured
    times, so they are left out."""
    return [line.split(":")[0].split("=")[0] for line in lines
            if not line.startswith("    t=")]


@pytest.mark.parametrize("daemon", [False, True])
def test_ppr_prints_the_same_lines_as_jax(daemon, capsys):
    # a deadline no measured time can miss: the lines, not the timing,
    # are compared
    argv = ["--workload", "ppr", "--dataset", "web-stanford", "--scale",
            "512", "--queries", "32", "--deadline", "3600", "--max-cores",
            "64"]
    if daemon:
        argv += ["--daemon", "--num-jobs", "3", "--arrival-rate", "2",
                 "--cache-size", "64"]
    got, want = _both(argv, capsys)
    assert _labels(got) == _labels(want)
    if daemon:
        # the arrival and the pool are inputs; the report is measured
        assert got[:2] == want[:2]
        assert got[2].split(" core_s=")[0].startswith("  jobs=3 done=3")
    else:
        assert got[0] == want[0]                  # dataset X T d
        assert got[-1] == want[-1] == "  slot mesh          : single chip"


def test_ppr_daemon_with_mutations_and_autotune_cache(tmp_path, capsys):
    path = tmp_path / "tune.json"
    assert autotune.main(["--cache", str(path), "--smoke", "--device",
                          "cpu"]) == 0
    lines = _lines(tserve.main, [
        "--workload", "ppr", "--scale", "512", "--daemon", "--num-jobs",
        "2", "--queries", "16", "--deadline", "20", "--max-cores", "8",
        "--mutation-rate", "4", "--mutations", "2", "--mutation-edges",
        "16", "--autotune-cache", str(path), "--device", "cpu"], capsys)
    assert any("mutations          : 2 applied (graph v2)" in line
               for line in lines)
    assert autotune.get_cache() is not None


def test_refusals(tmp_path, capsys):
    with pytest.raises(SystemExit, match="--devices 2"):
        tserve.main(["--workload", "ppr", "--devices", "2", "--device",
                     "cpu", "--scale", "512"])
    with pytest.raises(SystemExit, match="fused"):
        tserve.main(["--workload", "ppr", "--no-fused", "--device", "cpu",
                     "--scale", "512"])
    lines = _lines(tserve.main, ["--workload", "lm-decode", "--daemon",
                                 "--num-jobs", "2", "--queries", "20",
                                 "--lint-self", "--device", "cpu"], capsys)
    assert lines[0] == ("lint-self: WAL-logged modules are "
                        "replay-deterministic")
    args = tserve.build_parser().parse_args([])
    assert args.device == "cuda" and args.warm_start is None
    assert not hasattr(args, "platform")
    assert not hasattr(args, "compilation_cache")


@pytest.mark.parametrize("argv", [["--workload", "lm-decode"],
                                  ["--workload", "ppr", "--scale", "512"],
                                  ["--workload", "lm-decode", "--daemon"]])
def test_default_device_raises_without_a_card(argv):
    if torch.cuda.is_available():
        pytest.skip("needs a box without a card, where the default device "
                    "must raise")
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.main(argv)
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.main(argv + ["--device", "cuda"])

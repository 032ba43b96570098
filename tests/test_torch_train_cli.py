"""The port's training entry point, ``python -m repro_torch.launch.train``, on
the CPU (``--device cpu``): DIN and each GNN's smoke run for 30 steps with
gradient compression and an injected failure improve the loss (the
reference's own assertion, mean of the last 10 losses below the first
10's) at the entry point's defaults (batch 8, lr 3e-4), a run resumed from
its checkpoint gives the straight run's losses and final state bit for
bit, an LM arch or ``--preset lm100m`` raises ``NotImplementedError``, and
``--device cuda`` raises without a card. The DIN run's losses and gradient
norms, from the reference's initial parameters, are those that
``repro.launch.train`` prints on the same arguments: each loss within
half the printed last digit (4 decimals) plus 1e-5, each gradient norm
printed the same (3 decimals)."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.checkpoint.store import latest_step, restore_list
from repro_torch.launch import train

ROOT = Path(__file__).resolve().parents[1]


def _args(arch: str, ckpt: Path, steps: int, *extra: str) -> list[str]:
    return ["--arch", arch, "--steps", str(steps), "--device", "cpu",
            "--ckpt-dir", str(ckpt), "--ckpt-every", "10", "--log-every",
            "100", *extra]


@pytest.mark.parametrize("arch", ["din", "gcn-cora", "pna", "graphcast",
                                  "dimenet"])
def test_smoke_run_improves_the_loss(arch, tmp_path):
    out = train.main(_args(arch, tmp_path, 30, "--compress-grads",
                           "--fail-at", "15:0"))
    assert len(out["losses"]) == 30 and out["rescales"] == 1
    assert out["restored_from"] == [10]
    assert np.isfinite(out["losses"]).all()
    assert out["last10"] < out["first10"]
    assert latest_step(tmp_path) == 30


@pytest.mark.parametrize("arch", ["din", "gcn-cora"])
def test_resumed_run_equals_the_straight_run(arch, tmp_path):
    straight = train.main(_args(arch, tmp_path / "a", 30,
                                "--compress-grads"))
    first = train.main(_args(arch, tmp_path / "b", 20, "--compress-grads"))
    resumed = train.main(_args(arch, tmp_path / "b", 30, "--compress-grads",
                               "--resume"))
    assert resumed["start"] == 20
    assert first["losses"] + resumed["losses"] == straight["losses"]
    _, want = restore_list(tmp_path / "a", 30)
    _, got = restore_list(tmp_path / "b", 30)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("argv", [["--arch", "stablelm-1.6b"],
                                  ["--arch", "gemma-2b"],
                                  ["--arch", "din", "--preset", "lm100m"]])
def test_lm_training_raises(argv, tmp_path):
    with pytest.raises(NotImplementedError, match="1b"):
        train.main([*argv, "--device", "cpu", "--ckpt-dir", str(tmp_path)])


def test_cuda_without_a_card_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--arch", "din", "--steps", "2", "--ckpt-dir",
                    str(tmp_path)])


def test_module_entry_prints_the_summary(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", "din",
         "--steps", "3", "--device", "cpu", "--ckpt-dir", str(tmp_path),
         "--log-every", "1"], capture_output=True, text=True, timeout=120,
        cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin"})
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert sum(line.startswith("step ") for line in lines) == 3
    summary = json.loads(lines[-1])["train"]
    assert summary["steps"] == 3 and summary["device"] == "cpu"


def test_din_run_matches_the_reference_entry_point(monkeypatch, capsys,
                                                   tmp_path):
    import jax

    from repro.configs import get_arch as j_get_arch
    from repro.launch import train as j_train
    from repro.models.recsys import din as j_din
    from repro_torch.models.recsys import din

    argv = ["--arch", "din", "--steps", "30", "--log-every", "1"]
    monkeypatch.setattr(sys, "argv", ["train", *argv, "--ckpt-dir",
                                      str(tmp_path / "ref")])
    j_train.main()
    printed = [line.split() for line in capsys.readouterr().out.splitlines()
               if line.startswith("step ")]
    want_loss = [float(p[3]) for p in printed]
    want_norm = [float(p[5]) for p in printed]
    cfg = j_get_arch("din").smoke_cfg
    start = jax.tree.map(np.asarray, j_din.init(jax.random.PRNGKey(0), cfg))
    monkeypatch.setattr(din, "init", lambda cfg, gen, dev:
                        din.params_from_numpy(start, cfg, dev))
    out = train.main([*argv, "--device", "cpu", "--ckpt-dir",
                      str(tmp_path / "port")])
    got_norm = [float(line.split()[5]) for line in
                capsys.readouterr().out.splitlines()
                if line.startswith("step ")]
    assert len(want_loss) == len(out["losses"]) == 30
    np.testing.assert_allclose(out["losses"], want_loss, rtol=0,
                               atol=5e-5 + 1e-5)
    np.testing.assert_allclose(got_norm, want_norm, rtol=0, atol=1e-5)
    assert out["last10"] < out["first10"]

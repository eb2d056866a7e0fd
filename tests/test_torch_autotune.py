"""The port's autotuner (fastdnn_tpu_torch/cli/autotune.py) on the CPU,
after tools/autotune.py: a smoke run prints one registry entry whose knobs
are registry knobs, --commit is refused off the card and leaves the
registry byte for byte as it was, a candidate whose posteriors diverge is
disqualified by the gate, and --device cuda without a card raises.  The
sweep's times are 0 on the CPU; the card runs it in chip_smoke phase 26.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from fastdnn_tpu_torch import tuning
from fastdnn_tpu_torch.cli import autotune

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--device", "cpu", "--hidden", "128", "--layers", "3", "--out-dim", "256",
         "--batch", "128", "--reps", "2"]
ENTRY_KEYS = {"net", "batch", "platform", "device_kind", "default_ms", "best_ms",
              "speedup_vs_default", "knobs"}


def _entry(out: str) -> dict:
    lines = [ln for ln in out.splitlines() if ln.startswith("{") and ln.endswith("}")]
    assert lines, out[-2000:]
    return json.loads(lines[-1])


def test_smoke_run_prints_an_entry_of_registry_knobs(tmp_path):
    out = tmp_path / "entry.json"
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2", FASTDNN_TUNED="0")
    proc = subprocess.run(
        [sys.executable, "-m", "fastdnn_tpu_torch.cli.autotune", *SMALL, "--out", str(out)],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=240,
    )
    assert proc.returncode == 0, (proc.stdout + proc.stderr)[-3000:]
    entry = _entry(proc.stdout)
    assert set(entry) == ENTRY_KEYS
    assert set(entry["knobs"]) <= set(tuning.TUNED_KEYS) and entry["knobs"]
    assert entry["net"] == "432-3x128-256" and entry["batch"] == 128
    assert entry["platform"] == "cpu"
    assert json.loads(out.read_text()) == entry
    assert "bitwise the default" in proc.stdout and "disqualified" not in proc.stdout


def test_commit_off_the_card_is_refused_and_leaves_the_registry(tmp_path, monkeypatch, capsys):
    reg = tmp_path / "tuned.json"
    before = json.dumps({"entries": [{"net": "x", "device_kind": "y", "batch": 1,
                                      "knobs": {"stack_hidden_max_frames": 0}}]}) + "\n"
    reg.write_text(before)
    monkeypatch.setenv("FASTDNN_TUNED", str(reg))
    assert autotune.main([*SMALL, "--commit"]) == 1
    assert "--commit refused" in capsys.readouterr().out
    assert reg.read_bytes() == before.encode()


def test_diverging_candidate_is_disqualified(monkeypatch, capsys):
    """A candidate whose posteriors move is timed as inf and cannot win:
    the per-layer candidate here, so the stack wins at every B."""
    build = autotune._build

    class Diverging:
        def __init__(self, sc):
            self._sc = sc

        def score(self, frames):
            return self._sc.score(frames) + np.float32(1e-3)

        def score_device(self, frames):
            return self._sc.score_device(frames)

    def patched(qnet, device, **fields):
        sc = build(qnet, device, **fields)
        return Diverging(sc) if fields.get("stack_hidden_max_frames") == 0 else sc

    monkeypatch.setattr(autotune, "_build", patched)
    monkeypatch.setenv("FASTDNN_TUNED", "0")
    assert autotune.main(SMALL) == 0
    out = capsys.readouterr().out
    assert "per_layer {'stack_hidden_max_frames': 0} disqualified: posteriors differ" in out
    entry = _entry(out)
    assert entry["knobs"] == {"stack_hidden_max_frames": 128}  # the stack, never inf


def test_every_candidate_disqualified_is_fatal(monkeypatch, capsys):
    build = autotune._build

    def broken(qnet, device, **fields):
        if "stack_hidden_max_frames" in fields:  # the candidates, not the yardsticks
            raise ValueError("refused")
        return build(qnet, device, **fields)

    monkeypatch.setattr(autotune, "_build", broken)
    assert autotune.main(SMALL) == 2
    out = capsys.readouterr().out
    assert out.count("disqualified: ValueError: refused") == 2 and "FATAL" in out


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal without a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        autotune.main(["--batch", "256"])
    assert autotune._cli(["--batch", "256"]) == 2

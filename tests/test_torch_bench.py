"""The port's headline benchmark (fastdnn_tpu_torch/cli/bench.py) on the CPU,
against the JAX package's bench.py (at the repo root).

The numbers come from the card (chip_smoke.py phase 31); these tests pin
the mechanics at small widths, narrowed through the module's shape
constants: the timer (median after one warm-up), the chained marginal,
the chain's posteriors against the JAX scorer's on the same quantized net
(first link within 1e-4, argmax >= 99.9%; every link finite and
normalized), the JSON lines' keys against bench.py's, the CPU scaling grid
(rank 0 holds every point to the (1, 1) point within 1e-5), the bundled
configs failing as bench.py's do without their data, the refusal to run
on the CPU when the card was asked for, and the guard against JAX.
"""

import ast
import json
import math
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import fastdnn_tpu as fd
import fastdnn_tpu_torch as fdt
from fastdnn_tpu_torch.cli import bench as tbench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import bench as jbench  # noqa: E402
from conftest import REFERENCE_DATA  # noqa: E402

SMALL = (96, (128, 128), 500)  # tests/test_bench.py's net
POSTERIOR_ATOL = 1e-4
ARGMAX_AGREEMENT = 0.999


def _bench_py_result_keys() -> set:
    """The keys of the result dict bench.py's main prints."""
    tree = ast.parse(open(os.path.join(REPO, "bench.py")).read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(isinstance(t, ast.Name) and t.id == "result" for t in node.targets)):
            return {k.value for k in node.value.keys}
    raise AssertionError("bench.py has no result dict")


def _json_lines(text: str) -> list:
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]


@pytest.fixture(scope="module")
def carried(tmp_path_factory):
    """(port Scorer on the CPU, JAX Scorer) on one net: drawn by the port,
    quantized by the JAX package, carried back as the save_qnet arrays."""
    t_net = fdt.random_net(np.random.default_rng(3), SMALL[0], list(SMALL[1]), SMALL[2])
    j_q = fd.quantize_net(fd.from_raw(fdt.to_raw(t_net)))
    path = tmp_path_factory.mktemp("q") / "q.npz"
    fd.save_qnet(j_q, path)
    with np.load(path) as z:
        t_q = fdt.qnet_from_arrays({k: np.asarray(z[k]) for k in z.files})
    return (fdt.Scorer(t_q, fdt.EngineConfig(), device="cpu"),
            fd.Scorer(j_q, fd.EngineConfig(backend="xla")))


def test_synced_time_is_the_median_after_one_warmup(monkeypatch):
    clock = iter([0.0, 5.0, 10.0, 11.0, 20.0, 23.0])  # timed calls of 5, 1 and 3 s

    class FakeTime:
        @staticmethod
        def perf_counter():
            return next(clock)

    calls = []
    monkeypatch.setattr(tbench, "time", FakeTime)
    assert tbench.synced_time(lambda: calls.append(1), 3, "cpu") == 3.0
    assert len(calls) == 4  # the warm-up and three timed calls


def test_chained_marginal_finite(carried):
    """The counterpart of tests/test_bench.py::test_chained_marginal_finite,
    with a wider window (1 against 8 repetitions of 512 frames, median of
    5), so that a loaded CPU's jitter cannot invert the two times."""
    scorer, _ = carried
    frames = torch.from_numpy(
        np.random.default_rng(0).standard_normal((512, scorer.input_dim)).astype(np.float32))
    fps = tbench.chained_frames_per_s(scorer.score_device, frames, reps_lo=1, reps_hi=8,
                                      iters=5)
    assert math.isfinite(fps) and fps > 0


def test_chained_marginal_nan_and_narrow_output(carried, monkeypatch):
    scorer, _ = carried
    frames = torch.zeros((8, scorer.input_dim))
    times = iter([2.0, 1.0])  # t_lo, then a t_hi that is not larger
    monkeypatch.setattr(tbench, "synced_time", lambda fn, iters, device: next(times))
    assert math.isnan(tbench.chained_frames_per_s(scorer.score_device, frames, iters=1))
    with pytest.raises(ValueError, match="posterior width"):
        tbench.chained_frames_per_s(lambda x: x[:, :4], frames, iters=1)


def test_chain_matches_jax(carried):
    """The chain's links against the JAX scorer's chain (tests/
    test_bench.py's feedback): link 1 within 1e-4, argmax >= 99.9%; links
    1-3 finite, [32, 500], rows summing to 1 within 1e-4 in both."""
    scorer, j_scorer = carried
    frames = np.random.default_rng(1).standard_normal((32, SMALL[0])).astype(np.float32)
    x = jax.numpy.asarray(frames)
    for link in (1, 2, 3):
        p_jax = j_scorer._score(j_scorer.net, x)
        x = p_jax[:, :SMALL[0]] * 50.0
        p_jax = np.asarray(p_jax)
        p = tbench.chain(scorer.score_device, torch.from_numpy(frames), link).numpy()
        for got in (p, p_jax):
            assert got.shape == (32, SMALL[2]) and np.isfinite(got).all()
            np.testing.assert_allclose(got.sum(1), 1.0, atol=1e-4)
        if link == 1:
            assert np.abs(p - p_jax).max() <= POSTERIOR_ATOL
            assert (p.argmax(1) == p_jax.argmax(1)).mean() >= ARGMAX_AGREEMENT


def test_headline_line_has_bench_py_keys(monkeypatch, capsys):
    monkeypatch.setattr(tbench, "FLAGSHIP", SMALL)
    assert tbench.main(["--device", "cpu", "--quick", "--iters", "1"]) == 0
    lines = _json_lines(capsys.readouterr().out)
    assert len(lines) == 1
    line = lines[0]
    assert set(line) == _bench_py_result_keys() | {"score_device_ms", "device", "power_limit"}
    for key in ("value", "vs_baseline", "frames_per_s", "lazy_frames_per_s_40pct",
                "score_device_ms"):
        assert math.isfinite(line[key]) and line[key] > 0, key
    assert line["metric"] == "audio_seconds_per_second_per_chip_7x2048x8000"
    assert (line["platform"], line["backend"], line["batch"]) == ("cpu", "torch", 2048)
    assert (line["device"], line["power_limit"]) == ("cpu", None)


def test_midsize_lazy_prints_both_densities(monkeypatch, capsys):
    monkeypatch.setattr(tbench, "MIDSIZE", (*SMALL, 256))
    assert tbench.main(["--device", "cpu", "--config", "midsize-lazy", "--iters", "1"]) == 0
    lines = _json_lines(capsys.readouterr().out)
    assert len(lines) == 1
    assert set(lines[0]) == {"config", "lazy_frames_per_s_30pct", "lazy_frames_per_s_50pct"}
    for density in (30, 50):
        fps = lines[0][f"lazy_frames_per_s_{density}pct"]
        assert math.isfinite(fps) and fps > 0


def test_scaling_on_cpu_ranks(monkeypatch, capsys):
    """A data and a model split against (1, 1), each a gloo group of
    spawned CPU ranks; rank 0's 1e-5 check against (1, 1) runs in the rank
    and a failure there fails the config."""
    monkeypatch.setattr(tbench, "SCALING", (*SMALL[:2], 512, 64))
    grid = ((1, 1), (2, 1), (1, 2))
    out = tbench.run_config("scaling", 1, device="cpu", grid=grid)
    assert set(out) == {"config", "devices", "cards", "note",
                        "frames_per_s_dp1_tp1", "frames_per_s_dp2_tp1", "frames_per_s_dp1_tp2"}
    assert (out["devices"], out["cards"]) == (2, 0)
    for d, m in grid:
        assert out[f"frames_per_s_dp{d}_tp{m}"] > 0
    # the plain versions launch no kernel; the first point is held to the
    # plain route, the others to it
    err = capsys.readouterr().err
    for d, m in grid:
        assert f"# scaling dp{d} tp{m}: rank 0 launches per call {{}}; " in err
    assert "# scaling dp1 tp1: rank 0 launches per call {}; max |dp| 0 from the plain route" in err
    assert "# scaling dp2 tp1: rank 0 launches per call {}; within 1e-05 of dp1 tp1" in err


def test_scaling_holds_the_first_point_to_the_plain_route(tmp_path):
    """A first point whose posteriors stray from the plain route's (here a
    plain file that is not the net's) fails the config."""
    shape = (*SMALL[:2], 512, 64)
    np.save(tmp_path / "plain.npy", np.full((64, 512), 1 / 512, np.float32))
    with pytest.raises(RuntimeError, match="against the plain route"):
        tbench._run_grid_point(1, 1, "cpu", shape, 1, str(tmp_path / "plain.npy"),
                               str(tmp_path / "ref.npy"), is_ref=True)
    assert not (tmp_path / "ref.npy").exists()


def test_a_failing_rank_fails_the_config(tmp_path):
    """A rank that raises (here: a net with no hidden layer, which
    quantize_net refuses) fails the grid point with its traceback; it does
    not become a missing key, and no rank outlives the call."""
    with pytest.raises(RuntimeError, match="rank 0 failed") as failed:
        tbench._run_grid_point(1, 1, "cpu", (96, (), 500, 64), 1, str(tmp_path / "plain.npy"),
                               str(tmp_path / "ref.npy"), is_ref=True)
    assert "need at least an input layer" in str(failed.value)


@pytest.mark.parametrize("name", ["bundled-8khz", "bundled-16khz"])
def test_bundled_configs_fail_as_bench_py_does_without_the_data(name):
    """Each package reads its own copy of the files: bench.py the JAX
    tests' REFERENCE_DATA, the port the one under the checkout."""
    if tbench.REFERENCE_DATA.exists():
        pytest.skip(f"the bundled feature files are in the checkout ({tbench.REFERENCE_DATA})")
    if os.path.exists(REFERENCE_DATA):
        pytest.skip(f"bench.py's feature files are present ({REFERENCE_DATA})")
    with pytest.raises(Exception) as jax_error:
        jbench.run_config(name, "xla", 1)
    with pytest.raises(Exception) as port_error:
        tbench.run_config(name, 1, device="cpu")
    assert type(port_error.value) is type(jax_error.value) is FileNotFoundError


def test_cuda_without_a_card_prints_one_error_line(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal needs its absence")
    with pytest.raises(SystemExit) as exit_info:
        tbench.main(["--device", "cuda", "--quick"])
    assert exit_info.value.code == 1
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert set(line) == {"metric", "value", "unit", "vs_baseline", "error"}
    assert line["value"] is None and line["vs_baseline"] is None and "CUDA" in line["error"]


def test_no_jax_in_the_bench():
    path = os.path.join(REPO, "fastdnn_tpu_torch", "cli", "bench.py")
    text = open(path).read()
    for banned in ("import jax", "from jax", "ml_dtypes", "import fastdnn_tpu\n",
                   "from fastdnn_tpu.", "from fastdnn_tpu import", "import bench"):
        assert banned not in text, banned
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'ml_dtypes'): sys.modules[m] = None\n"
        "import fastdnn_tpu_torch.cli.bench\n"
        "assert not any(m in ('fastdnn_tpu', 'bench') or m.startswith(('fastdnn_tpu.', 'jax'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
        "print('ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=REPO, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr

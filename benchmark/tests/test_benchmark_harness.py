"""The harness on the CPU: its generators, its yardsticks, the net modules
and kernel files, BENCHMARK.json against its format, a run of every cell at
a small size, the faults that must read as not correct, and the import
guard."""

import json
import math
import os
import re
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import controls, generate, kernel_table, model, roofline, run, spec, timeline
from benchmark.record import Run

ROOT = spec.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [c["name"] for c in BENCH["workloads"]]
#: lazy_output's symbol as the profiler demangles it
LAZY_OUTPUT = ("void (anonymous namespace)::lazy_output_kernel(signed char const*, "
               "signed char const*, int const*, float const*, unsigned char const*, float*)")
SHORT = {"median": 150, "sigma": 0.6, "min": 100, "max": 400}
TINY_TRAFFIC = {  # entry -> {input part: parameters replaced}
    "score_device": {"ring": {"frames": 256}},
    "lazy_context": {"pool": {"size": 4, "kept": 1, "lengths": SHORT}},
}


def tiny(cell) -> dict:
    """The configuration keys that shrink the cell's net (its net module's
    TINY)."""
    return spec.net(spec.config(BENCH, spec.workload(BENCH, cell))).TINY


def tiny_run(cell, seed=5, seconds=0.3, trace=False, build=None):
    entry = spec.traffic(spec.workload(BENCH, cell))["entry"]
    return run.run_cell(BENCH, spec.workload(BENCH, cell), seed, seconds, trace, "cpu",
                        build=build, config_overrides=tiny(cell),
                        traffic_overrides=TINY_TRAFFIC[entry])


# -- generators ------------------------------------------------------------------------


@pytest.mark.parametrize("cell", CELLS)
def test_traffic_repeats_under_a_seed_and_differs_across_seeds(cell):
    params = spec.traffic(spec.workload(BENCH, cell))
    for part, values in TINY_TRAFFIC[params["entry"]].items():
        params["inputs"][part].update(values)
    config = dict(spec.config(BENCH, spec.workload(BENCH, cell)), **tiny(cell))
    a, b, c = (generate.make(params, s, config, "cpu") for s in (2**33 + 1, 2**33 + 1, 7))
    tensors = lambda t: t.batches or [torch.from_numpy(u) for u in t.utterances]
    assert all(torch.equal(x, y) for x, y in zip(tensors(a), tensors(b)))
    assert not all(torch.equal(x, y) for x, y in zip(tensors(a), tensors(c)))
    if a.masks is not None:
        assert all(np.array_equal(x, y) for x, y in zip(a.masks, b.masks))
        assert a.kept == b.kept
    if a.utterances:  # the same set of lengths, in another order
        la, lc = [len(u) for u in a.utterances], [len(u) for u in c.utterances]
        assert sorted(la) == sorted(lc) and la != lc


def test_lengths_follow_the_lognormal_quantiles():
    lens = generate.lengths({"median": 400, "sigma": 0.6, "min": 100, "max": 2000}, 256,
                            generate.numpy_rng(1, "pool"))
    assert np.median(lens) == pytest.approx(400, abs=3)
    assert lens.min() >= 100 and lens.max() <= 2000
    assert np.percentile(lens, 95) == pytest.approx(400 * math.exp(0.6 * 1.6449), rel=0.03)


def test_masks_keep_their_density_and_churn():
    rng = np.random.default_rng(3)
    masks = generate.generate_masks(rng, 50, 4000, 0.4, 0.03)
    assert (masks.sum(axis=1) == 1600).all()
    changed = (masks[1:] != masks[:-1]).sum(axis=1)
    assert (changed == 240).all()


def test_weights_repeat_under_a_seed():
    config = dict(spec.config(BENCH, spec.workload(BENCH, "flagship-dense")),
                  **tiny("flagship-dense"))
    a, b, c = (model.draw(config, s, "cpu") for s in (9, 9, 10))
    assert all(torch.equal(x, y) for x, y in zip(a.weights, b.weights))
    assert not torch.equal(a.weights[1], c.weights[1])
    assert a.weights[0].shape == (432, 256) and not a.weights[0][429:].any()
    assert not a.shift[429:].any() and not a.scale[429:].any()
    assert a.weights[1].std().item() == pytest.approx(256 ** -0.5, rel=0.05)


# -- yardsticks --------------------------------------------------------------------------


def _config(name):
    return json.loads((ROOT / "benchmark" / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("name, layer, ops, precision", [
    ("flagship", "input_layer", 14.50e9, "tf32"),
    ("flagship", "trunk", 412.3e9, "int8"),
    ("flagship", "output_dense", 268.4e9, "int8"),
    ("flagship", "output_lazy", 13.11e6, "int8"),
])
def test_layer_operations_equal_the_hand_counts(name, layer, ops, precision):
    counts = {"hidden_frames": 8192, "output_frames": 8192, "lazy_active": 3200}
    work = roofline.request_work(_config(name), counts)
    assert work[layer].ops == pytest.approx(ops, rel=1e-3)
    assert work[layer].precision == precision


def test_layer_bytes_and_bounds():
    work = roofline.request_work(_config("flagship"), {"hidden_frames": 8192, "output_frames": 8192})
    # K4: 16.8 MB of activations, 16.4 MB of weights, 262 MB of posteriors
    assert work["output_dense"].bytes == pytest.approx(295.2e6, rel=1e-3)
    assert work["output_dense"].bound_s == pytest.approx(268.4e9 / 1979e12, rel=1e-3)
    assert work["trunk"].bound_s == pytest.approx(412.3e9 / 1979e12, rel=1e-3)
    assert work["input_layer"].bound_s == pytest.approx(14.50e9 / 495e12, rel=1e-3)
    small = roofline.request_work(_config("flagship"), {"output_frames": 1})["output_dense"]
    assert small.bound_s == pytest.approx(small.bytes / 3.35e12)  # bytes-bound at one frame
    lazy = roofline.request_work(_config("flagship"), {"lazy_active": 3200})["output_lazy"]
    assert lazy.ops == 2 * 2048 * 3200
    assert lazy.bytes == 2048 + 3200 * 2048 + 8 * 3200 + 8000 + 4 * 8000
    assert lazy.bound_s == pytest.approx(lazy.bytes / 3.35e12)


def test_kernel_table_is_the_programs():
    from fastdnn_tpu_torch.cli import profile

    symbols = [
        "void fdn::streamed_layer_kernel<fdn::LogitsEpilogue>(...)",
        "void fdn::streamed_layer_kernel<fdn::SigmoidEpilogue>(...)",
        "void fdn::resident_softmax_wgmma_kernel<0, true, 2>(...)",
        "void fdn::resident_softmax_wgmma_kernel<0, false, 2>(...)",
        "void fdn::flash_stats_kernel<1, 0, true>(...)",
        "void fdn::input_layer_kernel<2>(...)", "fdn::hidden_stack_wgmma_kernel<1>",
        LAZY_OUTPUT,
        "Memcpy DtoH (Device -> Pageable)", "void at::native::reduce_kernel<512, 1>(...)",
    ]
    for s in symbols:
        assert kernel_table.kernel_of(s) == profile.kernel_of(s)
    ours, other = kernel_table.by_kernel([(s, 1.0) for s in symbols])
    assert {kernel_table.layer_of(n) for n in ours} == {"output_lazy", "trunk", "output_dense",
                                                         "input_layer"}
    assert list(other) == symbols[-2:]
    assert kernel_table.is_copy(symbols[-2]) and not kernel_table.is_copy(symbols[-1])


def test_timeline_arithmetic():
    merged = timeline.union([(0, 1), (0.5, 2), (3, 4), (3.5, 3.6), (5, 6)])
    assert merged.tolist() == [[0, 2], [3, 4], [5, 6]]
    assert timeline.covered(merged, 1.5, 3.5) == pytest.approx(1.0)
    assert timeline.gaps(merged, (0, 7)).tolist() == [[2, 3], [4, 5], [6, 7]]
    host = [(0, 10, "a"), (1, 2, "b"), (3, 4, "c"), (3.1, 3.2, "d")]
    assert timeline.innermost(host, [0.5, 1.5, 2.5, 3.15, 3.5, 11]) == \
        ["a", "b", "a", "d", "c", None]


def _synthetic_run():
    """Two dense requests of 1 ms, each with three of the port's kernels,
    and one lazily scored frame with K5 and a PyTorch kernel."""
    k9, k3, k4 = ("void input_layer_kernel<1>", "hidden_stack_wgmma_kernel<1>",
                  "resident_softmax_wgmma_kernel<0, false, 2>")
    counts = {"frames": 8192, "hidden_frames": 8192, "output_frames": 8192}
    tl = timeline.Timeline(
        window=(0.0, 2e-3),
        requests=[(0.0, 1e-3, counts), (1e-3, 2e-3, counts)],
        device=[(0.0, 1e-4, k9), (1e-4, 5e-4, k3), (5e-4, 9e-4, k4),
                (1e-3, 1.1e-3, k9), (1.1e-3, 1.5e-3, k3), (1.5e-3, 1.9e-3, k4)],
        host=[(0.0, 2e-3, "bench.request")],
    )
    return Run({"name": "flagship-dense"}, _config("flagship"), {}, 1.0, [], tl)


def test_readers_on_a_synthetic_trace():
    r = _synthetic_run()
    read = lambda name: spec.reader(name).read(r)
    assert read("device.idle_pct") == pytest.approx(10.0)
    assert read("dispatch.kernels_per_request") == pytest.approx(3.0)
    assert read("entry.host_ms_per_request.lazy") == pytest.approx(0.1)
    assert read("input_layer_roofline") == pytest.approx(100 * (14.50e9 / 495e12) / 1e-4, rel=1e-3)
    assert read("trunk_roofline") == pytest.approx(100 * (412.3e9 / 1979e12) / 4e-4, rel=1e-3)
    peak = 14.50e9 / 495e12 + 412.3e9 / 1979e12 + 268.4e9 / 1979e12
    assert read("step_mfu") == pytest.approx(100 * peak / 1e-3, rel=1e-3)
    assert read("output_lazy_roofline") is None  # no lazy frame: nothing to read
    br = timeline.breakdown(r.timeline)
    assert br["device_ops"][0][0] in ("hidden_stack", "resident_softmax")
    assert br["idle_gaps"] == [["bench.request", pytest.approx(2e-4)]]


def test_readers_without_a_trace_read_nothing():
    r = Run({"name": "x"}, _config("flagship"), {}, 1.0, [], None)
    for entry in BENCH["per_layer"]:
        assert spec.reader(entry["name"]).read(r) is None


# -- net modules and kernel files --------------------------------------------------------


def test_a_configuration_without_a_net_is_the_feedforward_net():
    path = lambda m: Path(m.__file__)
    default = ROOT / "benchmark" / "nets" / "feedforward.py"
    assert path(spec.net({})) == default == path(spec.net({"net": "feedforward"}))
    assert spec.net({}) is spec.net({"net": "feedforward"})  # loaded once a process
    for cell in BENCH["workloads"]:
        assert path(spec.net(spec.config(BENCH, cell))) == default
    with pytest.raises(KeyError, match="nets/no_such_net.py"):
        spec.net({"net": "no_such_net"})


def test_the_feedforward_net_binds_the_harness_functions():
    from benchmark import program
    from benchmark.reference.net import ReferenceNet

    ff = spec.net({})
    assert ff.draw is model.draw and ff.build is program.build_scorer
    assert ff.work is roofline.request_work
    config = dict(_config("flagship"), **ff.TINY)
    weights = ff.draw(config, 4, "cpu")
    frames = torch.randn(40, 429, generator=torch.Generator().manual_seed(4))
    for rounding in (None, "tf32"):
        ref = ff.reference(config, weights, "cpu", input_rounding=rounding)
        assert isinstance(ref, ReferenceNet) and ref.input_rounding == rounding
        plain = ReferenceNet(weights, config["cutoff"], "cpu", input_rounding=rounding)
        assert torch.equal(ref.posteriors(frames), plain.posteriors(frames))


@pytest.mark.parametrize("name", ["run.py", "roofline.py", "controls.py"])
def test_the_harness_reaches_a_net_only_through_its_module(name):
    source = (ROOT / "benchmark" / name).read_text()
    assert "specs.net(" in source
    for hook in ("model.draw", "build_scorer", "ReferenceNet"):
        assert hook not in source, hook


def test_kernel_files_name_lazy_output():
    files = kernel_table.kernel_files(kernel_table.KERNELS)
    assert files == (("lazy_output", "lazy_output_kernel", "output_lazy"),)
    assert kernel_table.kernel_of(LAZY_OUTPUT) == "lazy_output"
    assert kernel_table.layer_of("lazy_output") == "output_lazy"
    assert kernel_table.op_name(LAZY_OUTPUT) == "lazy_output"


def _kernel_files(tmp_path, monkeypatch, files: dict):
    for name, symbol in files.items():
        (tmp_path / f"{name}.json").write_text(json.dumps({"symbol": symbol, "layer": "trunk"}))
    monkeypatch.setattr(kernel_table, "KERNELS", tmp_path)


def test_a_kernel_file_may_not_take_a_built_in_name(tmp_path, monkeypatch):
    _kernel_files(tmp_path, monkeypatch, {"bottleneck": "bottleneck_kernel",
                                          "hidden_stack": "stack_v2_kernel"})
    with pytest.raises(ValueError, match="hidden_stack.json.*built-in"):
        kernel_table.kernel_of("void bottleneck_kernel<1>(...)")


def test_no_symbol_may_match_two_kernel_files(tmp_path, monkeypatch):
    _kernel_files(tmp_path, monkeypatch, {"bottleneck": "bottleneck_kernel",
                                          "bottleneck_wide": "bottleneck_kernel_wide"})
    assert kernel_table.kernel_of("void bottleneck_kernel<1>(...)") == "bottleneck"
    assert kernel_table.layer_of("bottleneck") == "trunk"
    with pytest.raises(ValueError, match="bottleneck, bottleneck_wide"):
        kernel_table.kernel_of("void bottleneck_kernel_wide<1>(...)")
    assert kernel_table.kernel_of("void hidden_stack_wgmma_kernel<1>") == "hidden_stack"


@pytest.mark.parametrize("sub, symbol, built_in", [
    ("flash_stats_kernel<1, 0, false, 7>", "void fdn::flash_stats_kernel<1, 0, false, 7>(...)",
     "flash_stats"),
    ("SigmoidEpilogue<256>", "void fdn::streamed_layer_kernel<fdn::SigmoidEpilogue<256> >(...)",
     "hidden_layer"),
])
def test_no_symbol_may_match_a_built_in_rule_and_a_kernel_file(tmp_path, monkeypatch, sub,
                                                               symbol, built_in):
    _kernel_files(tmp_path, monkeypatch, {"factored_layer": sub})
    with pytest.raises(ValueError, match=f"named {built_in!r} by a built-in rule.*factored_layer"):
        kernel_table.kernel_of(symbol)
    other = symbol.replace("256", "128").replace("7>", "0>")  # what the file does not match
    assert kernel_table.kernel_of(other) == built_in


def _synthetic_lazy_run():
    """Four lazily scored frames: each the mask's upload, lazy_output and
    the posteriors' download; the third also a PyTorch kernel."""
    device, requests = [], []
    for i in range(4):
        t = i * 1.7e-4
        requests.append((t, t + 1.6e-4, {"frames": 1, "lazy_active": 3000 + 100 * i}))
        device += [(t + 1e-5, t + 1.3e-5, "Memcpy HtoD (Pinned -> Device)"),
                   (t + 2e-5, t + 2e-5 + (1.21 + 0.07 * i) * 1e-5, LAZY_OUTPUT),
                   (t + 4e-5, t + 4.3e-5, "Memcpy DtoH (Device -> Pinned)")]
    device.append((3.9e-4, 3.93e-4, "void at::native::vectorized_elementwise_kernel<4>(...)"))
    tl = timeline.Timeline(window=(0.0, 6.7e-4), requests=requests, device=sorted(device),
                           host=[(s, e, "bench.request") for s, e, _ in requests])
    return Run({"name": "flagship-lazy-context"}, _config("flagship"), {}, 1.0, [], tl)


def test_output_lazy_roofline_is_the_same_with_and_without_its_kernel_file(tmp_path,
                                                                              monkeypatch):
    r = _synthetic_lazy_run()
    read = lambda: spec.reader("output_lazy_roofline").read(r)
    named = read()
    device_s = sum((1.21 + 0.07 * i) * 1e-5 for i in range(4)) + 3e-6
    bound_s = sum(roofline.output_lazy(r.config, 3000 + 100 * i).bound_s for i in range(4))
    assert named == pytest.approx(100 * bound_s / device_s, rel=1e-9)
    assert dict(timeline.breakdown(r.timeline)["device_ops"])["lazy_output"] > 0
    monkeypatch.setattr(kernel_table, "KERNELS", tmp_path)  # no kernel file
    assert kernel_table.kernel_of(LAZY_OUTPUT) is None
    assert read() == named  # to the last bit
    assert "lazy_output" not in dict(timeline.breakdown(r.timeline)["device_ops"])


# -- BENCHMARK.json against its format ------------------------------------------------------

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")


def test_benchmark_json_keys_names_and_units():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert all(TEXT.match(w) for w in BENCH["command"]) and len(BENCH["command"]) <= 32
    assert BENCH["paths"] == ["benchmark"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and TEXT.match(c["source"]) and TEXT.match(c["why"])
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
        assert c["reduced"] == [] == json.loads((ROOT / c["file"]).read_text())["reduced"]
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and TEXT.match(w["why"])
        assert w["chips"] == 1
        mix = json.loads((ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json").read_text())
        assert (ROOT / "benchmark" / "entries" / f"{mix['entry']}.py").is_file()
        assert all((ROOT / "benchmark" / "inputs" / f"{p}.py").is_file() for p in mix["inputs"])
        assert (ROOT / "benchmark" / "checks" / f"{w['name']}.json").is_file()
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(names)) == len(names)
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert TEXT.match(m["layer"]) and m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert set(m.get("workloads", [])) <= set(CELLS)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").is_file()
    for cell in CELLS:  # every cell reports set-up, another end-to-end metric, a per-layer one
        e2e = {m["name"] for m in spec.metrics(BENCH, spec.workload(BENCH, cell), False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert spec.metrics(BENCH, spec.workload(BENCH, cell), True)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_checks_give_each_number_its_readings():
    for cell in CELLS:
        checks = json.loads((ROOT / "benchmark" / "checks" / f"{cell}.json").read_text())
        for name, entry in checks.items():
            assert entry["lower"] < entry["limit"] < entry["upper"]


# -- runs of every cell at a small size --------------------------------------------------


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_runs_and_is_correct(cell, trace):
    result = tiny_run(cell, trace=trace)
    assert result["correct"] and result["failed"] == 0 and result["attempted"] > 0
    expected = {m["name"] for m in spec.metrics(BENCH, spec.workload(BENCH, cell), trace)}
    assert set(result["metrics"]) <= expected
    if not trace:
        assert set(result["metrics"]) == expected
    else:  # no device on the CPU: only host-side per-layer readings
        assert result["device"]["busy_s"] == 0 and result["device"]["window_s"] > 0
        assert len(result["breakdown"]["idle_gaps"]) <= 10
    assert list(result)[-1] == "checks"


class Faulty:
    """The program with one fault planted where its answers are made."""

    def __init__(self, scorer, fault):
        self.s, self.fault, self.last = scorer, fault, None

    def _plant(self, out):
        if self.fault == "stale":  # the state lags a step: the previous call's answer
            last, self.last = self.last, out
            return out if last is None else last
        out = out.clone() if isinstance(out, torch.Tensor) else out.copy()
        if self.fault == "half":  # half of the rows (for one frame, senones) left out
            if out.ndim == 1:
                out[out.shape[0] // 2:] = 0
            else:
                out[out.shape[0] // 2:] = 0
        elif self.fault == "altered":  # one answer altered: the first row uniform
            row = out if out.ndim == 1 else out[0]
            row[:] = 1.0 / row.shape[0]
        return out

    def score_device(self, frames):
        return self._plant(self.s.score_device(frames))

    def score(self, frames):
        return self._plant(self.s.score(frames))

    def new_lazy_context(self, n):
        outer, ctx = self, self.s.new_lazy_context(n)

        class Ctx:
            def calculate_until_output(self, frames):
                ctx.calculate_until_output(frames)
                self.t = 0

            def calculate_for_output_nodes(self, mask):
                p = ctx.calculate_for_output_nodes(mask)
                self.t += 1
                if outer.fault == "altered" and self.t > 1:
                    return p  # only each utterance's first frame is altered
                return outer._plant(p)

        return Ctx()


@pytest.mark.parametrize("fault", ["stale", "half", "altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_planted_faults_read_as_not_correct(cell, fault):
    from benchmark.program import build_scorer

    build = lambda config, net, device: Faulty(build_scorer(config, net, device), fault)
    result = tiny_run(cell, build=build)
    assert result["failed"] == 0 and not result["correct"]


@pytest.mark.parametrize("variant", ["tf32", "bf16", "int4"])
@pytest.mark.parametrize("cell", CELLS)
def test_controls_read_as_not_correct(cell, variant):
    """Each control, at a size a test run holds, fails the cell's limit."""
    result = tiny_run(cell, build=controls.system_for(variant))
    assert not result["correct"]
    value = result["checks"]["worst_mean_row_l1"]
    assert value["value"] > value["limit"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_controls_fail_at_the_cells_own_size(cell):
    """On the card: the program on three seeds is correct, each control on
    three seeds is not (python3 -m benchmark.controls reads the same)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    c = spec.workload(BENCH, cell)
    for variant in ("program", "tf32", "bf16", "int4"):
        for seed in (101, 102, 103):
            result = run.run_cell(BENCH, c, seed, 2.0, False, "cuda:0",
                                  build=controls.system_for(variant))
            assert result["correct"] == (variant == "program"), (variant, seed, result["checks"])


# -- the command, the guard, and cells added as files ------------------------------------


def test_command_refuses_without_a_cuda_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", CELLS[0],
                          "--seed", str(2**32 + 3), "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=str(ROOT), timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_command_refuses_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; from benchmark import run, spec; s = spec.load(); "
            "r = run.run_cell(s, spec.workload(s, sys.argv[1]), 1, 0.2, False, 'cpu')")
    out = subprocess.run([sys.executable, "-c", code, CELLS[0]], capture_output=True,
                         text=True, cwd=str(tmp_path), timeout=120)
    assert out.returncode != 0 and "fastdnn_tpu_torch" in out.stderr and out.stdout == ""


GUARD = textwrap.dedent("""
    import json, sys
    from benchmark import run, spec
    from benchmark.tests.test_benchmark_harness import tiny_run
    for cell in [c["name"] for c in spec.load()["workloads"]]:
        for trace in (False, True):
            assert tiny_run(cell, seconds=0.1, trace=trace)["correct"]
    print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
""")


def test_a_run_loads_no_jax_and_no_jax_package():
    out = subprocess.run([sys.executable, "-c", GUARD], capture_output=True, text=True,
                         cwd=str(ROOT), timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "fastdnn_tpu_torch" in loaded and "torch" in loaded
    assert not loaded & set(run.FORBIDDEN)


def test_guard_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "fastdnn_tpu_torch_x", sys)
    assert run.forbidden_modules() == [] or "jax" in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "fastdnn_tpu.engine", sys)
    assert "fastdnn_tpu" in run.forbidden_modules()


ADDED_METRIC = textwrap.dedent('''
    """frames_per_request: a throwaway metric added as a file."""


    def read(run):
        return sum(r.counts["frames"] for r in run.requests) / len(run.requests)
''')

ADDED_INPUT = textwrap.dedent('''
    """gaps: exponential gaps between arrivals, a throwaway input part."""

    from benchmark.generate import numpy_rng


    def make(params, seed, config, device, traffic):
        traffic.gaps = numpy_rng(seed, "gaps").exponential(params["mean_s"], params["count"])
''')

ADDED_ENTRY = textwrap.dedent('''
    """score_paced: Scorer.score sent at the arrivals of traffic.gaps, a
    throwaway entry that reuses the score caller's warm-up and comparison."""

    import time

    import numpy as np

    from benchmark.caller import Request
    from benchmark.spec import caller


    class Paced(caller("score")):
        def run(self, seconds, span):
            pool, requests = self.traffic.utterances, []
            deadline = time.perf_counter() + seconds
            for i, gap in enumerate(self.traffic.gaps):
                time.sleep(gap)
                idx = i % len(pool)
                t0 = time.perf_counter()
                with span():
                    res = self.scorer.score(pool[idx])
                t1 = time.perf_counter()
                if idx in self._buffers and idx not in self.answers:
                    np.copyto(self._buffers[idx], res)
                    self.answers[idx] = self._buffers[idx]
                n = len(pool[idx])
                requests.append(Request(t0, t1, True, {"frames": n, "hidden_frames": n,
                                                       "output_frames": n}))
                if t1 >= deadline:
                    break
            return requests


    CALLER = Paced
''')


def test_a_cell_an_entry_and_a_metric_are_added_as_files_alone(tmp_path):
    """A new entry, input part, traffic mix, cell, limits file and metric,
    added as new files and entries in a copy, run with no edit to any file
    that was there."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in (tmp_path / "benchmark").rglob("*") if p.is_file()}
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "flagship-paced", "config": "flagship",
                               "traffic": "paced_utterances", "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "frames_per_request", "unit": "frames",
                                "better": "higher", "bound": 0.05, "source": "host_clock",
                                "workloads": ["flagship-paced"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    traffic = {"entry": "score_paced",
               "inputs": {"pool": {"size": 4, "kept": 1, "lengths": SHORT},
                          "gaps": {"mean_s": 0.01, "count": 1000}}}
    bench_dir = tmp_path / "benchmark"
    (bench_dir / "traffic" / "paced_utterances.json").write_text(json.dumps(traffic))
    (bench_dir / "checks" / "flagship-paced.json").write_text(
        json.dumps({"worst_mean_row_l1": {"limit": 1e-4, "lower": 0, "upper": 1}}))
    (bench_dir / "metrics" / "frames_per_request.py").write_text(ADDED_METRIC)
    (bench_dir / "inputs" / "gaps.py").write_text(ADDED_INPUT)
    (bench_dir / "entries" / "score_paced.py").write_text(ADDED_ENTRY)
    code = ("import json; from benchmark import run, spec; s = spec.load(); "
            "print(json.dumps(run.run_cell(s, spec.workload(s, 'flagship-paced'), 3, 0.2, "
            "False, 'cpu', config_overrides={'hidden_widths': [256, 256], 'output_dim': 500})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=str(tmp_path), timeout=300,
                         env={**os.environ, "PYTHONPATH": f"{tmp_path}:{ROOT}"})
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["metrics"]["frames_per_request"]["value"] >= 100
    assert all(p.read_bytes() == b for p, b in before.items())


TOY_NET = textwrap.dedent('''
    """toy: the feed-forward net under a name of its own, a throwaway net
    module that appends the name of each hook it is called through to the
    file that $TOY_CALLS names, and imports fastdnn_tpu in the hook that
    $TOY_IMPORTS names."""

    import os

    from benchmark import spec

    _ff = spec.module("nets", "feedforward")
    TINY = _ff.TINY


    def _called(hook):
        with open(os.environ["TOY_CALLS"], "a") as f:
            f.write(hook + "\\n")
        if os.environ.get("TOY_IMPORTS") == hook:
            import fastdnn_tpu  # noqa: F401


    def draw(config, seed, device):
        _called("draw")
        return _ff.draw(config, seed, device)


    def build(config, weights, device, engine=None, hidden_bits=None):
        _called("build")
        return _ff.build(config, weights, device, engine, hidden_bits)


    def reference(config, weights, device, input_rounding=None):
        _called("reference")
        return _ff.reference(config, weights, device, input_rounding)


    def work(config, counts):
        _called("work")
        return _ff.work(config, counts)
''')

TOY_RUN = textwrap.dedent('''
    import json, os
    from benchmark import roofline, run, spec, timeline
    from benchmark.record import Run
    from benchmark.tests.test_benchmark_harness import TINY_TRAFFIC, Faulty

    resolved = []
    _net = spec.net


    def net(config):  # every lookup of a net, as the harness makes it
        module = _net(config)
        resolved.append(os.path.basename(module.__file__))
        return module


    spec.net = net
    s = spec.load()
    cell = spec.workload(s, "toy-lazy-context")  # its seed keeps the pool's first utterance
    config = spec.config(s, cell)
    small = dict(config_overrides=spec.net(config).TINY,
                 traffic_overrides=TINY_TRAFFIC["lazy_context"])
    ok = run.run_cell(s, cell, 2**33 + 1, 0.3, True, "cpu", **small)
    fault = lambda c, w, d: Faulty(spec.net(c).build(c, w, d), "altered")
    bad = run.run_cell(s, cell, 2**33 + 1, 0.3, False, "cpu", build=fault, **small)
    frame = {"frames": 1, "lazy_active": 300}
    tl = timeline.Timeline(window=(0.0, 1e-3), requests=[(0.0, 1e-3, frame)],
                           device=[(1e-4, 2e-4, "void toy_output_kernel<1>(signed char*)")])
    toy = Run(cell, dict(config, **small["config_overrides"]), {}, 1.0, [], tl)
    print(json.dumps({"resolved": sorted(set(resolved)), "ok": ok, "bad": bad,
                      "share": roofline.layer_share(toy, "output_lazy"),
                      "breakdown": timeline.breakdown(tl)}))
''')


def _only_added(old, new) -> bool:
    """Whether `new` is `old` with entries added: list items at the end,
    dict keys anywhere, at any depth."""
    if isinstance(old, dict):
        return isinstance(new, dict) and all(k in new and _only_added(v, new[k])
                                             for k, v in old.items())
    if isinstance(old, list):
        return (isinstance(new, list) and len(new) >= len(old)
                and all(_only_added(a, b) for a, b in zip(old, new)))
    return old == new


def _toy_checkout(tmp_path):
    """A copy of the checkout with the toy net added as new files and
    entries: its module, a configuration that names it, a cell on the
    lazy frames, its limits and a kernel file.  -> (the copy, its benchmark
    files before the additions, the toy configuration)."""
    copy = tmp_path / "checkout"
    copy.mkdir()
    shutil.copy(ROOT / "BENCHMARK.json", copy)
    shutil.copytree(ROOT / "benchmark", copy / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench_dir = copy / "benchmark"
    before = {p: p.read_bytes() for p in bench_dir.rglob("*") if p.is_file()}
    bench = json.loads((copy / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "toy", "source": "https://github.com/ahmetaa/fast-dnn",
                             "file": "benchmark/configs/toy.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "toy-lazy-context", "config": "toy",
                               "traffic": "lazy_frames", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "flagship-lazy-context" in m.get("workloads", []):
            m["workloads"].append("toy-lazy-context")
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))
    (bench_dir / "nets" / "toy.py").write_text(TOY_NET)
    toy_config = dict(_config("flagship"), name="toy", net="toy")
    (bench_dir / "configs" / "toy.json").write_text(json.dumps(toy_config))
    shutil.copy(bench_dir / "checks" / "flagship-lazy-context.json",
                bench_dir / "checks" / "toy-lazy-context.json")
    (bench_dir / "kernels" / "toy_output.json").write_text(
        json.dumps({"symbol": "toy_output_kernel", "layer": "output_lazy"}))
    return copy, before, toy_config


def test_a_net_is_added_as_new_files_alone(tmp_path):
    """The toy net, added as new files and entries in a copy, run on the
    CPU: every lookup of a net finds the new module, each of its hooks is
    called, the run is correct and a planted fault is not, and the new
    kernel's time counts in its layer."""
    copy, before, toy_config = _toy_checkout(tmp_path)
    bench_dir = copy / "benchmark"
    calls = tmp_path / "toy.calls"
    out = subprocess.run([sys.executable, "-c", TOY_RUN], capture_output=True, text=True,
                         cwd=str(copy), timeout=300,
                         env={**os.environ, "PYTHONPATH": f"{copy}:{ROOT}",
                              "TOY_CALLS": str(calls)})
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["resolved"] == ["toy.py"]
    assert set(calls.read_text().split()) == {"draw", "build", "reference", "work"}
    ok, bad = result["ok"], result["bad"]
    assert ok["correct"] and ok["failed"] == 0 and ok["attempted"] > 0
    assert bad["failed"] == 0 and not bad["correct"]
    lazy = roofline.output_lazy(dict(toy_config, **spec.net({}).TINY), 300)
    assert result["share"] == pytest.approx(100 * lazy.bound_s / 1e-4)
    assert result["breakdown"]["device_ops"] == [["toy_output", pytest.approx(1e-4)]]

    assert all(p.read_bytes() == b for p, b in before.items())
    added = {p for p in bench_dir.rglob("*") if p.is_file() and "__pycache__" not in p.parts}
    assert {p.relative_to(bench_dir).as_posix() for p in added - set(before)} == {
        "nets/toy.py", "configs/toy.json", "checks/toy-lazy-context.json",
        "kernels/toy_output.json"}
    assert _only_added(BENCH, json.loads((copy / "BENCHMARK.json").read_text()))


TOY_LEAK = textwrap.dedent('''
    import json, sys
    from benchmark import run, spec
    from benchmark.tests.test_benchmark_harness import TINY_TRAFFIC

    s = spec.load()
    cell = spec.workload(s, "toy-lazy-context")
    result = run.run_cell(s, cell, 2**33 + 5, 0.3, True, "cpu",
                          config_overrides=spec.net(spec.config(s, cell)).TINY,
                          traffic_overrides=TINY_TRAFFIC["lazy_context"])
    print(json.dumps({"result": result, "loaded": "fastdnn_tpu" in sys.modules}))
''')


@pytest.mark.parametrize("hook", ["reference", "work"])
def test_a_net_that_loads_the_jax_package_after_the_window_gives_no_result(tmp_path, hook):
    """A net module whose reference or work, which run once the window has
    closed, imports the JAX package (here a stub under its name): the run
    gives no result and names what it found."""
    copy, _, _ = _toy_checkout(tmp_path)
    stub = tmp_path / "stub" / "fastdnn_tpu"
    stub.mkdir(parents=True)
    (stub / "__init__.py").write_text('"""A stub under the JAX package\'s name."""\n')
    calls = tmp_path / "toy.calls"
    out = subprocess.run([sys.executable, "-c", TOY_LEAK], capture_output=True, text=True,
                         cwd=str(copy), timeout=300,
                         env={**os.environ, "PYTHONPATH": f"{stub.parent}:{copy}:{ROOT}",
                              "TOY_CALLS": str(calls), "TOY_IMPORTS": hook})
    assert out.returncode == 0, out.stderr[-2000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert hook in calls.read_text().split() and result["loaded"]
    assert result["result"] is None
    assert "forbidden modules loaded: fastdnn_tpu" in out.stderr

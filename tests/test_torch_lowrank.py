"""The SVD-restructured net (Xue, Li, Gong, Interspeech 2013) on the CPU:
low-rank layers (models.feedforward.LowRank) through the public set-up path
(FeedForwardNet -> quantize_net -> Scorer, the default EngineConfig),
held to the benchmark's plain reference (benchmark/reference/lowrank.py),
on both backends: the plain versions, and the kernels' routes and layout
(their wrappers run the plain versions on CPU tensors).

Tolerances:
  * the quantized mirror: both sides take the input layer's product in
    float64 rounded once to f32, every integer product exactly, and the
    bottleneck's codes, scales and dequantization with the same f32 ops, so
    every sigmoid count agrees bit for bit (checked); the posteriors differ
    only by the order of the softmax's f32 sums, a few ulps an entry: at
    most ROW_L1 of L1 a row;
  * the float forward: the int8 factors, the 8-bit sigmoid counts and the
    8-bit bottleneck codes move each posterior row by under 1e-2 of L1 on
    these nets (a mean of 0.0063 and 0.0066 on the seed below, 0.0073 at the
    configuration's full widths); FLOAT_ROW_L1 allows 3x that, and a net
    whose last bottleneck was lost reads 0.32 or more;
  * restructure at full rank: the SVD's product in float64, its factors
    rounded to f32, so the float forward moves by f32 rounding alone.
"""

import dataclasses
import json
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import fastdnn_tpu_torch as fdt
from benchmark import generate, roofline, spec
from benchmark.reference import compare
from fastdnn_tpu_torch.engine import backend as backend_mod
from fastdnn_tpu_torch.engine import scorer as scorer_mod
from fastdnn_tpu_torch.engine.scorer import Route, check_lowrank
from fastdnn_tpu_torch.formats import kaldi_text
from fastdnn_tpu_torch.ops import kernels
from fastdnn_tpu_torch.ops import matmul as plain

NETS = spec.module("nets", "lowrank")
CONFIG = json.loads((spec.HERE / "configs" / "svd.json").read_text())
#: the benchmark's cell limit for this net
LIMIT = json.loads((spec.HERE / "checks" / "svd-dense.json").read_text())
LIMIT = LIMIT["worst_mean_row_l1"]["limit"]
#: two small nets: the TINY size, and a rank that pads to the kernels' 128
SMALL = {"tiny": dict(CONFIG, **NETS.TINY),
         "rank96": dict(CONFIG, hidden_widths=[384, 256], rank=96, output_dim=777)}
FRAMES = 200
SEED = 2**33 + 25
#: the largest L1 distance of a posterior row from the mirror's: the
#: softmax's f32 sums in another order (module docstring)
ROW_L1 = 2e-6
#: the largest mean row L1 distance from the float forward (module docstring)
FLOAT_ROW_L1 = 0.02


@pytest.fixture(scope="module", params=list(SMALL))
def case(request):
    config = SMALL[request.param]
    net = NETS.draw(config, SEED, "cpu")
    frames = generate.features((FRAMES,), SEED, config, "cpu")
    rng = generate.numpy_rng(SEED, "masks")
    masks = generate.generate_masks(rng, FRAMES, config["output_dim"], 0.4)
    return config, net, frames, masks


def _scorer(config, net, backend, monkeypatch, **engine):
    """The program through the net module's set-up path; "kernels" makes the
    Scorer hold the kernels' backend (layout, padding and routes) on the
    CPU, without the registry of launch knobs, which reads the card."""
    if backend == "kernels":
        monkeypatch.setattr(scorer_mod, "get_backend", lambda name: backend_mod.KERNELS)
        engine = dict(engine, autotuned=False)
    return NETS.build(config, net, "cpu", engine=engine)


def _active_only(ref, frames, masks):
    z = ref.logits(ref.hidden(frames))
    active = torch.as_tensor(masks) != 0
    e = torch.where(active, torch.exp(z - torch.where(active, z, -torch.inf).amax(1, keepdim=True)),
                    0.0)
    return torch.nan_to_num(e / e.sum(1, keepdim=True))


def _worst_row_l1(a, b) -> float:
    return float((torch.as_tensor(a).double() - torch.as_tensor(b).double()).abs().sum(1).max())


@pytest.mark.parametrize("backend", ["plain", "kernels"])
def test_hidden_counts_agree_bit_for_bit(case, backend, monkeypatch):
    config, net, frames, _ = case
    sc = _scorer(config, net, backend, monkeypatch)
    ref = NETS.reference(config, net, "cpu")
    padded, n = sc._prepare(frames.numpy())
    acts = sc._route.hidden(sc.net, padded)[:n, : config["hidden_widths"][-1]]
    assert torch.equal(acts.to(torch.float64) + 128, ref.hidden(frames))


@pytest.mark.parametrize("backend", ["plain", "kernels"])
@pytest.mark.parametrize("entry", ["score", "score_device", "score_masked.reference",
                                   "score_masked.active_only", "lazy.reference",
                                   "lazy.active_only"])
def test_the_program_matches_the_mirror(case, backend, entry, monkeypatch):
    config, net, frames, masks = case
    semantics = entry.split(".")[1] if "." in entry else "reference"
    sc = _scorer(config, net, backend, monkeypatch, lazy_semantics=semantics)
    ref = NETS.reference(config, net, "cpu")
    if entry == "score":
        got, want = sc.score(frames.numpy()), ref.posteriors(frames)
    elif entry == "score_device":
        x = torch.nn.functional.pad(frames[:128], (0, config["input_dim"] - frames.shape[1]))
        got, want = sc.score_device(x), ref.posteriors(frames[:128])
    else:
        want = (ref.masked_posteriors(frames, torch.as_tensor(masks)) if semantics == "reference"
                else _active_only(ref, frames, masks))
        if entry.startswith("score_masked"):
            got = sc.score_masked(frames.numpy(), masks)
        else:
            ctx = sc.new_lazy_context(FRAMES)
            ctx.calculate_until_output(frames.numpy())
            got = np.stack([ctx.calculate_for_output_nodes(masks[i]) for i in range(FRAMES)])
    assert got.shape == tuple(want.shape)
    assert _worst_row_l1(got, want) <= ROW_L1


@pytest.mark.parametrize("backend", ["plain", "kernels"])
def test_a_frame_does_not_depend_on_its_batch(case, backend, monkeypatch):
    """Each frame's bottleneck scale is its own: a frame scored alone, among
    other companions or in another order reads the same bits."""
    config, net, frames, _ = case
    sc = _scorer(config, net, backend, monkeypatch)
    x = frames.numpy()
    whole = sc.score(x)
    order = np.random.default_rng(3).permutation(FRAMES)
    assert np.array_equal(sc.score(x[order]), whole[order])
    for i in (0, 17, FRAMES - 1):
        assert np.array_equal(sc.score(x[i : i + 1])[0], whole[i])
    scaled = x.copy()
    scaled[1:] *= 3.0  # other frames far louder: the first frame's scale is unchanged
    assert np.array_equal(sc.score(scaled)[0], whole[0])


def test_the_program_is_near_the_float_forward(case):
    config, net, frames, _ = case
    sc = NETS.build(config, net, "cpu")
    ref = NETS.reference(config, net, "cpu")
    floats = ref.float_posteriors(frames)
    row = (torch.as_tensor(sc.score(frames.numpy())).double() - floats.double()).abs().sum(1)
    assert float(row.mean()) <= FLOAT_ROW_L1
    # the same comparison sees a net whose last bottleneck was lost
    p, e = net.factors[-1]
    lost = dataclasses.replace(net, factors=net.factors[:-1] + ((torch.zeros_like(p), e),))
    row = (NETS.reference(config, lost, "cpu").posteriors(frames).double()
           - floats.double()).abs().sum(1)
    assert float(row.mean()) > 3 * FLOAT_ROW_L1


def _span_names(fn) -> list:
    """The program's span names that `fn` records under a CPU profiler, in
    order of their start."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    events = sorted((e.time_range.start, e.name) for e in prof.events()
                    if e.name.startswith("fastdnn."))
    return [name for _, name in events]


def test_the_output_bottleneck_records_its_span(case):
    """score_device and calculate_until_output record fastdnn.output_bottleneck
    once, after the trunk's span; a lazy frame records none; the posteriors
    are the same bits with the profiler running."""
    config, net, frames, masks = case
    sc = NETS.build(config, net, "cpu")
    x = torch.nn.functional.pad(frames[:64], (0, config["input_dim"] - frames.shape[1]))
    plain_out = sc.score_device(x)
    traced = []
    names = _span_names(lambda: traced.append(sc.score_device(x)))
    assert names == ["fastdnn.score_device", "fastdnn.trunk_layers", "fastdnn.output_bottleneck"]
    assert torch.equal(traced[0], plain_out)
    ctx = sc.new_lazy_context(8)
    names = _span_names(lambda: ctx.calculate_until_output(frames[:8].numpy()))
    assert names == ["fastdnn.lazy.until_output", "fastdnn.trunk_layers",
                     "fastdnn.output_bottleneck"]
    names = _span_names(lambda: ctx.calculate_for_output_nodes(masks[0]))
    assert "fastdnn.output_bottleneck" not in names and "fastdnn.output_lazy" in names
    assert "fastdnn.output_bottleneck" in scorer_mod.SPANS


def test_restructure_at_full_rank_reproduces_the_float_net():
    net = fdt.random_net(np.random.default_rng(4), 44, [96, 64], 50)
    full = fdt.restructure(fdt.restructure(net, 64, [1]), 50, [2])
    assert [w.rank for w in full.weights[1:]] == [64, 50]
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((64, 44)).astype(np.float32))
    a, b = fdt.forward(net, x), fdt.forward(full, x)
    assert float((a - b).abs().max()) < 1e-6
    cut = fdt.restructure(net, 8)  # a real truncation moves it
    assert float((fdt.forward(cut, x) - a).abs().max()) > 1e-4
    with pytest.raises(ValueError, match="input layer"):
        fdt.restructure(net, 8, [0])


def test_four_bit_codes_read_not_correct_at_the_cells_limit(case):
    """The reference with a 4-bit bottleneck ([-7, 7]): one precision below
    the contract's codes, the comparison has to tell it apart."""
    config, net, frames, _ = case
    got = torch.as_tensor(NETS.build(config, net, "cpu").score(frames.numpy()))
    exact = NETS.reference(config, net, "cpu").posteriors(frames)
    coarse = NETS.reference(config, net, "cpu", code_bits=4).posteriors(frames)
    ok, _ = compare.judge(compare.numbers([compare.row_l1(got, exact)]),
                          {"worst_mean_row_l1": LIMIT})
    bad, checks = compare.judge(compare.numbers([compare.row_l1(got, coarse)]),
                                {"worst_mean_row_l1": LIMIT})
    assert ok and not bad
    assert checks["worst_mean_row_l1"]["value"] > 10 * LIMIT


def test_the_contracts_all_zero_row():
    """A frame whose bottleneck is all zero takes scale 0 and codes 0, on the
    plain version and through the kernel's wrapper alike."""
    acts = torch.randint(-128, 128, (64, 256), dtype=torch.int8)
    w = torch.zeros(256, 128, dtype=torch.int8)
    zero = torch.zeros(128, dtype=torch.int32)
    codes, scale = plain.bottleneck_step(acts, w, zero, torch.tensor(0.01), torch.tensor(0.5))
    assert not codes.any() and not scale.any()
    k_codes, k_scale = kernels.lowrank_bottleneck(acts, kernels.kernel_layout(w), zero,
                                                  torch.tensor(0.01), torch.tensor(0.5))
    assert torch.equal(k_codes, codes) and torch.equal(k_scale, scale)


def test_the_codes_span_their_range():
    acts = torch.randint(-128, 128, (64, 512), dtype=torch.int8)
    w = torch.randint(-30, 31, (512, 128), dtype=torch.int8)
    cs = 128 * w.to(torch.int32).sum(0, dtype=torch.int32)
    codes, scale = plain.bottleneck_step(acts, w, cs, torch.tensor(1e-4), torch.tensor(0.25))
    z = (plain.int8_matmul(acts, w) + cs).float() * 1e-4
    assert torch.equal(codes.abs().amax(1), torch.full((64,), 127, dtype=torch.int8))
    assert torch.equal(scale, (z.abs().amax(1) / 127.0) * torch.tensor(0.25))


@pytest.mark.parametrize("knob, engine", [
    ("fused_softmax=False", {"fused_softmax": False}),
    ("fast_posteriors=True", {"fast_posteriors": True}),
    ("lazy_mode='block_sparse'", {"lazy_mode": "block_sparse"}),
    ("lazy_mode='gathered'", {"lazy_mode": "gathered"}),
    ("int4_packed=True", {"int4_packed": True}),
])
def test_set_up_refuses_the_knobs_without_a_low_rank_route(knob, engine):
    config = SMALL["tiny"]
    net = NETS.draw(config, SEED, "cpu")
    with pytest.raises(ValueError, match=knob.replace("(", r"\(").replace(")", r"\)")):
        NETS.build(config, net, "cpu", engine=engine)


def test_a_mesh_an_int4_trunk_and_a_wide_rank_are_refused():
    config = SMALL["tiny"]
    net = NETS.draw(config, SEED, "cpu")
    with pytest.raises(ValueError, match="no int4 form"):
        NETS.build(config, net, "cpu", hidden_bits=4)
    qnet = NETS.build(config, net, "cpu").net
    with pytest.raises(ValueError, match="a mesh"):
        check_lowrank(qnet, fdt.EngineConfig(), mesh=object())
    lowrank = fdt.quantize_net(fdt.random_lowrank_net(np.random.default_rng(2), 40, [128], 60, 32))
    with pytest.raises(ValueError, match="a mesh"):  # the mesh programs' own set-up
        backend_mod.PLAIN.prepare(lowrank, "cpu", mesh=object())
    wide = dict(config, rank=384)
    with pytest.raises(ValueError, match="rank 384"):
        NETS.build(wide, NETS.draw(wide, SEED, "cpu"), "cpu")
    with pytest.raises(ValueError, match="low-rank"):
        fdt.save_qnet(qnet, "unused.npz")
    frames = torch.zeros(64, config["input_dim"])
    with pytest.raises(ValueError, match="fused softmax only"):  # the free function's default
        fdt.score_fn(NETS.build(config, net, "cpu").net, frames, backend="torch")


def test_a_dense_net_keeps_its_route():
    """A net without low-rank layers has no bottlenecks and takes no
    bottleneck step."""
    q = fdt.quantize_net(fdt.random_net(np.random.default_rng(6), 40, [128, 128], 300))
    assert q.bottlenecks == () and not q.has_lowrank
    acts, scale = Route(backend_mod.PLAIN, 300).until_output(
        q, torch.randn(64, 40, generator=torch.Generator().manual_seed(1)))
    assert scale is None and acts.shape == (64, 128)


def _lowrank_text(raw) -> str:
    """A RawNetwork as nnet1 text: a low-rank layer as a <LinearTransform>
    (no bias row) followed by an <AffineTransform>."""
    def matrix(m):
        rows = [" ".join(repr(float(v)) for v in row) for row in m]
        return ["[ " + rows[0], *["  " + r for r in rows[1:-1]], "  " + rows[-1] + " ]"]

    out = ["<Nnet>"]
    for i, layer in enumerate(raw.layers):
        if layer.bottleneck is not None:
            out.append(f"<LinearTransform> {layer.bottleneck.shape[0]} {layer.input_dim}")
            out.append("<LearnRateCoef> 1")
            out += matrix(layer.bottleneck)
        out.append(f"<AffineTransform> {layer.output_dim} {layer.weights.shape[1]}")
        out.append("<LearnRateCoef> 1 <BiasLearnRateCoef> 1")
        out += matrix(layer.weights)
        out.append("[ " + " ".join(repr(float(v)) for v in layer.bias) + " ]")
        out.append(("<Softmax> {0} {0}" if i == len(raw.layers) - 1 else "<Sigmoid> {0} {0}")
                   .format(layer.output_dim))
    out.append("</Nnet>")
    return "\n".join(out) + "\n"


def test_kaldi_text_reads_a_linear_and_an_affine_transform_as_one_low_rank_layer(tmp_path):
    net = fdt.random_lowrank_net(np.random.default_rng(8), 12, [32, 24], 10, 6)
    raw = fdt.to_raw(net)
    (tmp_path / "net.txt").write_text(_lowrank_text(raw))
    (tmp_path / "tr.txt").write_text("[ {} ]\n[ {} ]\n".format(
        " ".join(repr(float(v)) for v in raw.shift), " ".join(repr(float(v)) for v in raw.scale)))
    back = fdt.load_model_text(tmp_path / "net.txt", tmp_path / "tr.txt")
    assert isinstance(back.weights[0], torch.Tensor)
    for a, b in zip(net.weights[1:], back.weights[1:]):
        assert torch.equal(a.project, b.project) and torch.equal(a.expand, b.expand)
    assert all(torch.equal(a, b) for a, b in zip(net.biases, back.biases))
    x = np.random.default_rng(9).standard_normal((70, 12)).astype(np.float32)
    want = fdt.Scorer(fdt.quantize_net(net), device="cpu").score(x)
    assert np.array_equal(fdt.Scorer(fdt.quantize_net(back), device="cpu").score(x), want)
    # a <LinearTransform> with nothing after it, or two in a row, is refused
    lone = "<LinearTransform> 2 3\n[ 1 2 3\n 4 5 6 ]\n"
    for text in (lone, lone + lone + "<AffineTransform> 1 2\n[ 1 2 ]\n[ 0 ]\n"):
        with pytest.raises(ValueError, match="LinearTransform"):
            kaldi_text.parse_network_text(text)
    with pytest.raises(ValueError, match="binary model format"):
        fdt.write_model(raw, tmp_path / "m.bin")


HARNESS_RUN = """
import json
from benchmark import controls, spec
from benchmark.tests.test_benchmark_harness import Faulty, tiny_run
out = {"runs": [tiny_run("svd-dense", seed=2**33 + 7, trace=t) for t in (False, True)]}
for fault in ("stale", "half", "altered"):
    build = lambda c, w, d: Faulty(spec.net(c).build(c, w, d), fault)
    out[fault] = tiny_run("svd-dense", build=build)
for variant in ("tf32", "bf16"):
    out[variant] = tiny_run("svd-dense", build=controls.system_for(variant))
try:
    tiny_run("svd-dense", build=controls.system_for("int4"))
except ValueError as e:
    out["int4"] = str(e)
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def harness():
    """The svd-dense cell at its net's TINY size, as the harness's own tests
    run a cell: plain, traced, with each planted fault and each control; in
    a process of its own (a run gives no result in a process that loaded
    JAX, as this test process may have)."""
    out = subprocess.run([sys.executable, "-c", HARNESS_RUN], capture_output=True, text=True,
                         cwd=str(spec.ROOT), timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_the_harness_runs_the_lowrank_net_at_its_tiny_size(harness):
    bench = spec.load()
    cell = spec.workload(bench, "svd-dense")
    assert spec.config(bench, cell)["net"] == "lowrank"
    for trace, result in zip((False, True), harness["runs"]):
        assert result["correct"] and result["failed"] == 0 and result["attempted"] > 0
        expected = {m["name"] for m in spec.metrics(bench, cell, trace)}
        assert set(result["metrics"]) <= expected
        if not trace:
            assert set(result["metrics"]) == expected
        else:  # the host-side readings, the new span's among them
            assert "output_bottleneck.host_ms_per_request" in result["metrics"]
            assert "trunk_layers.host_ms_per_request" in result["metrics"]


@pytest.mark.parametrize("fault", ["stale", "half", "altered"])
def test_planted_faults_read_as_not_correct_in_the_new_cell(harness, fault):
    assert harness[fault]["failed"] == 0 and not harness[fault]["correct"]


@pytest.mark.parametrize("variant", ["tf32", "bf16"])
def test_controls_read_as_not_correct_in_the_new_cell(harness, variant):
    value = harness[variant]["checks"]["worst_mean_row_l1"]
    assert not harness[variant]["correct"] and value["value"] > value["limit"]


def test_the_int4_control_does_not_apply(harness):
    """A low-rank layer has no int4 form: the program refuses it at set-up."""
    assert "no int4 form" in harness["int4"]


def test_the_work_counts_equal_the_hand_counts():
    work = NETS.work(CONFIG, {"hidden_frames": 8192, "output_frames": 8192, "lazy_active": 2400})
    assert work["input_layer"].ops == pytest.approx(2 * 8192 * 432 * 2048)
    # four low-rank layers, 2 k (m + n) a frame each: 68.7 G
    assert work["trunk"].ops == pytest.approx(4 * 2 * 8192 * 256 * (2048 + 2048))
    assert work["trunk"].ops == pytest.approx(68.72e9, rel=1e-3)
    # the output's bottleneck (8.59 G) and its expand product (25.07 G)
    assert work["output_dense"].ops == pytest.approx(2 * 8192 * 256 * (2048 + 5976))
    assert work["output_dense"].bytes > 4 * 8192 * 5976  # the f32 posteriors bound it
    assert work["output_dense"].bound_s == pytest.approx(work["output_dense"].bytes / 3.35e12)
    assert work["output_lazy"].ops == 2 * 256 * 2400
    # 7.1 M multiply-adds a frame against 29.9 M at full rank
    per_frame = sum(w.ops for name, w in work.items() if name != "output_lazy") / 2 / 8192
    assert per_frame == pytest.approx(7.1e6, rel=0.02)
    dense = roofline.request_work(dict(CONFIG, net="feedforward"), {"hidden_frames": 1,
                                                                   "output_frames": 1})
    assert sum(w.ops for w in dense.values()) / 2 == pytest.approx(29.9e6, rel=0.02)


@pytest.mark.cuda
def test_k10_and_the_bottleneck_are_their_plain_versions_bitwise():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator().manual_seed(11)
    for b, k, rank, n in [(64, 2048, 256, 2048), (8320, 2048, 256, 2048), (192, 384, 128, 640)]:
        acts = torch.randint(-128, 128, (b, k), generator=g, dtype=torch.int8)
        p = torch.randint(-20, 21, (k, rank), generator=g, dtype=torch.int8)
        e = torch.randint(-60, 61, (rank, n), generator=g, dtype=torch.int8)
        pcs = 128 * p.to(torch.int32).sum(0, dtype=torch.int32)
        ecs = torch.zeros(n, dtype=torch.int32)
        bias = torch.randn(n, generator=g)
        args = (torch.tensor(1 / 7905.0), torch.tensor(1 / 40.0))
        want = plain.lowrank_layer_step(acts, p, pcs, args[0], e, ecs, args[1], bias)
        d = lambda t: t.cuda()
        p_t, e_t, pcs_d, bias_d = (d(kernels.kernel_layout(p)), d(kernels.kernel_layout(e)),
                                   d(pcs), d(bias))
        kernels.check_lowrank_layer(p_t, pcs_d, e_t, bias_d)
        got = kernels.lowrank_layer(d(acts), p_t, pcs_d, args[0], e_t, d(ecs), args[1], bias_d)
        assert torch.equal(got.cpu(), want)
        codes, scale = kernels.lowrank_bottleneck(d(acts), p_t, pcs_d, *args)
        w_codes, w_scale = plain.bottleneck_step(acts, p, pcs, *args)
        assert torch.equal(codes.cpu(), w_codes) and torch.equal(scale.cpu(), w_scale)

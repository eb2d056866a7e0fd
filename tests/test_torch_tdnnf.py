"""Kaldi's TDNN-F chain net (models.tdnnf) on the CPU: through the public
set-up path (TdnnfNet -> quantize_net -> Scorer, the default EngineConfig),
held to the benchmark's plain reference (benchmark/reference/tdnnf.py) at
its TINY widths with run_tdnn_1d's strides, on both backends: the plain
versions, and the kernels' routes and layout (their wrappers run the plain
versions on CPU tensors).  With the `cuda` mark, each new kernel against
its plain version on the card.

Tolerances:
  * the quantized mirror: both sides take tdnn1's product in float64 in
    the order of k, every integer product exactly and every epilogue with
    the same f32 ops, so the outputs agree bit for bit (checked);
  * the float equations: the int8 matrices and the per-row int8 codes of 34
    requantizations in a row move the outputs by 0.21 of their mean
    magnitude at TINY (mean |diff| / mean |y|, one seed), growing about 1%
    a layer; FLOAT_REL allows 0.35, and a net without its bypass reads 1.06,
    without its batchnorms 4.5, with a stride of 1 for 3 more than 0.9;
  * every new kernel bit for bit against its plain version.  tdnn1 runs
    its own f64 kernel, not K9's 3xTF32: a last-bit difference in its f32
    product flips a code now and then, and the 34 requantizations that
    follow carry the flip across the chunk (four flipped codes in a TINY
    batch move 61 of its 400 output rows, up to 12% of a row's L1), so the
    cell's comparison could not tell such flips from a lower precision.
"""

import dataclasses
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

import fastdnn_tpu_torch as fdt
from benchmark import spec
from fastdnn_tpu_torch.engine import backend as backend_mod
from fastdnn_tpu_torch.engine import scorer as scorer_mod
from fastdnn_tpu_torch.engine.tdnnf import TdnnfRoute
from fastdnn_tpu_torch.models import tdnnf as mt
from fastdnn_tpu_torch.ops import kernels
from fastdnn_tpu_torch.ops import matmul as plain
from fastdnn_tpu_torch.quant.quantize import QuantizedTdnnf

NETS = spec.module("nets", "tdnnf")
CONFIG = json.loads((spec.HERE / "configs" / "tdnnf.json").read_text())
TINY = dict(CONFIG, **NETS.TINY)
SEED = 2**33 + 27
CHUNKS = 3
FRAMES = 150
#: the largest relative distance of the quantized outputs from the float
#: equations (module docstring)
FLOAT_REL = 0.35


def _chunks(config, chunks=CHUNKS, frames=FRAMES, seed=SEED):
    traffic = type("T", (), {})()
    spec.module("inputs", "chunks").make({"batches": 1, "chunks": chunks, "frames": frames},
                                         seed, config, torch.device("cpu"), traffic)
    return traffic.batches[0]


@pytest.fixture(scope="module")
def case():
    net = NETS.draw(TINY, SEED, "cpu")
    return net, _chunks(TINY)


def _scorer(net, backend, monkeypatch, **engine):
    """The program through the net module's set-up path; "kernels" makes
    the Scorer hold the kernels' backend (layout and routes) on the CPU."""
    if backend == "kernels":
        monkeypatch.setattr(scorer_mod, "get_backend", lambda name: backend_mod.KERNELS)
    return NETS.build(TINY, net, "cpu", engine=engine)


@pytest.mark.parametrize("backend", ["plain", "kernels"])
def test_the_program_matches_the_reference_bit_for_bit(case, backend, monkeypatch):
    net, chunks = case
    scorer = _scorer(net, backend, monkeypatch)
    assert scorer.backend == ("cuda" if backend == "kernels" else "torch")
    want = NETS.reference(TINY, net, "cpu").posteriors(chunks)
    got = scorer.score_device(chunks)
    assert got.shape == (CHUNKS, FRAMES // 3, TINY["output_dim"])
    assert torch.equal(got, want)
    assert np.array_equal(scorer.score(chunks.numpy()), want.numpy())


def test_score_pads_narrow_rows_and_checks_shapes(case):
    net, chunks = case
    scorer = NETS.build(TINY, net, "cpu")
    narrow = chunks.numpy().copy()
    narrow[:, :, 200:] = 0.0
    assert np.array_equal(scorer.score(narrow[:, :, :200]), scorer.score(narrow))
    for bad in (chunks[0], chunks[:, :, :200]):
        with pytest.raises(ValueError, match="chunks must be"):
            scorer.score_device(bad)
    with pytest.raises(ValueError, match="multiple of 3"):
        scorer.score_device(chunks[:, :-1])


def test_the_context_is_the_strides(case):
    net, _ = case
    assert NETS.build(TINY, net, "cpu").context == (39, 39)
    assert mt.context(mt.LIBRISPEECH_STRIDES) == (39, 39)
    assert mt.drop_layer(mt.LIBRISPEECH_STRIDES, 3) == 3
    plan = mt.chunk_rows(150, mt.LIBRISPEECH_STRIDES, 3)
    assert plan == {"rows": 228, "first": 0, "rows_low": 76, "out_first": 13, "outputs": 50}


def test_chunked_scoring_equals_whole_utterance_scoring(case):
    """Each output frame with its full context inside the utterance reads
    the same in any chunking: one chunk over the whole utterance against
    chunks of 30 and of 60 frames with their own context rows."""
    net, _ = case
    scorer = NETS.build(TINY, net, "cpu")
    left, right = scorer.context
    frames = 180
    rows = _chunks(TINY, chunks=1, frames=frames, seed=SEED + 1)[0]
    whole = scorer.score(rows[None].numpy())[0]
    for t in (30, 60):
        starts = range(0, frames, t)
        chunked = np.stack([rows[s: s + left + t + right].numpy() for s in starts])
        got = scorer.score(chunked).reshape(-1, TINY["output_dim"])
        assert np.array_equal(got, whole)


def test_outputs_sit_at_every_third_frame(case):
    """Dropping the first three rows of a chunk moves every output one row
    on; dropping one row gives other frames, none of the outputs."""
    net, _ = case
    scorer = NETS.build(TINY, net, "cpu")
    rows = _chunks(TINY, chunks=1, frames=FRAMES + 3, seed=SEED + 2)
    a = scorer.score(rows[:, :-3].numpy())[0]
    b = scorer.score(rows[:, 3:].numpy())[0]
    assert a.shape == (FRAMES // 3, TINY["output_dim"])
    assert np.array_equal(a[1:], b[:-1])
    c = scorer.score(rows[:, 1:-2].numpy())[0]
    assert not any(np.array_equal(c[i], a[j]) for i in range(len(c)) for j in range(len(a)))


class StrideFault(QuantizedTdnnf):
    """A planted fault: the stride-3 layers read at a stride of 1, at the
    full rate (never subsampled), the outputs still every third row."""

    def context(self):
        return 39, 39

    def plan(self, chunk_frames):
        rows = 39 + chunk_frames + 39
        return {"rows": rows, "first": 0, "rows_low": rows // 3, "out_first": 13,
                "outputs": chunk_frames // 3, "drop": len(self.layers)}


def plant(qnet: QuantizedTdnnf, fault: str) -> QuantizedTdnnf:
    """The quantized net with one fault planted: "bypass" dropped, "bn"
    skipped (gamma 1, beta 0) or "stride" (StrideFault)."""
    if fault == "bypass":
        return dataclasses.replace(qnet, bypass_scale=torch.tensor(0.0))
    if fault == "bn":
        return dataclasses.replace(qnet, layers=tuple(
            dataclasses.replace(layer, gamma=torch.ones_like(layer.gamma),
                                beta=torch.zeros_like(layer.beta)) for layer in qnet.layers))
    layers = tuple(dataclasses.replace(layer, stride=1) if layer.stride == 3 else layer
                   for layer in qnet.layers)
    fields = {f.name: getattr(qnet, f.name) for f in dataclasses.fields(qnet)}
    return StrideFault(**dict(fields, layers=layers))


@pytest.mark.parametrize("fault", [None, "bypass", "bn", "stride"])
def test_the_quantized_contract_is_near_the_float_equations(case, fault):
    net, chunks = case
    want = NETS.reference(TINY, net, "cpu").float_outputs(chunks)
    tnet = NETS.build(TINY, net, "cpu").net
    qnet = tnet if fault is None else plant(tnet, fault)
    got = TdnnfRoute(backend_mod.PLAIN).score(qnet, chunks)
    rel = float((got - want).abs().mean() / want.abs().mean())
    if fault is None:
        assert rel < FLOAT_REL
    else:
        assert rel > 2 * FLOAT_REL


def test_the_program_float_forward_is_the_references(case):
    """The port's own float forward (models.tdnnf.forward) and the
    reference's, on the same weights, within f32 rounding."""
    net, chunks = case
    scorer = NETS.build(TINY, net, "cpu")
    ref = NETS.reference(TINY, net, "cpu")
    fnet = _float_net(net)
    assert fnet.context() == scorer.context
    torch.testing.assert_close(mt.forward(fnet, chunks), ref.float_outputs(chunks),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("backend", ["plain", "kernels"])
@pytest.mark.parametrize("knob", ["mesh", "int4_packed", "fast_posteriors", "gathered",
                                  "block_sparse", "bf16_input"])
def test_set_up_refuses_the_knobs_without_a_time_context_route(case, backend, knob, monkeypatch):
    net, _ = case
    if backend == "kernels":
        monkeypatch.setattr(scorer_mod, "get_backend", lambda name: backend_mod.KERNELS)
    qnet = fdt.quantize_net(_float_net(net))
    engine = {"int4_packed": {"int4_packed": True}, "fast_posteriors": {"fast_posteriors": True},
              "gathered": {"lazy_mode": "gathered"},
              "bf16_input": {"input_precision": "default"}}.get(knob, {})
    if knob == "block_sparse":
        engine = {"lazy_mode": "block_sparse"}
    with pytest.raises(ValueError, match="time context"):
        fdt.Scorer(qnet, fdt.EngineConfig(**engine), device="cpu",
                   mesh=object() if knob == "mesh" else None)


def _float_net(net):
    bn = lambda stats: fdt.BatchNorm(*stats)
    return fdt.TdnnfNet(net.input_w, net.input_b, bn(net.input_bn), tuple(
        fdt.TdnnfLayer(layer.stride, layer.linear, layer.affine, layer.bias, bn(layer.bn))
        for layer in net.layers), net.prefinal_l, net.prefinal_w, net.prefinal_b,
        bn(net.prefinal_bn), net.prefinal_small, bn(net.prefinal_small_bn), net.output_w,
        net.output_b)


@pytest.mark.parametrize("backend", ["plain", "kernels"])
@pytest.mark.parametrize("entry", ["LazyContext", "score_masked", "score_utterances",
                                   "StreamingScorer", "save_qnet", "int4"])
def test_the_entries_that_rest_on_frame_independence_refuse(case, backend, entry, monkeypatch,
                                                           tmp_path):
    net, chunks = case
    scorer = _scorer(net, backend, monkeypatch)
    frames = chunks[0].numpy()
    calls = {
        "LazyContext": lambda: scorer.new_lazy_context(len(frames)),
        "score_masked": lambda: scorer.score_masked(frames, np.ones((len(frames), 1000))),
        "score_utterances": lambda: scorer.score_utterances([frames]),
        "StreamingScorer": lambda: fdt.StreamingScorer(scorer),
        "save_qnet": lambda: fdt.save_qnet(scorer.net, tmp_path / "q.npz"),
        "int4": lambda: fdt.quantize_net(_float_net(net), hidden_bits=4),
    }
    match = {"save_qnet": "checkpoint", "int4": "int4"}.get(entry, "time context")
    with pytest.raises(ValueError, match=match):
        calls[entry]()
    with pytest.raises(ValueError, match="time context"):
        fdt.LazyContext(scorer, 10)


def test_the_output_chain_records_its_span(case):
    from torch.profiler import ProfilerActivity, profile

    net, chunks = case
    scorer = NETS.build(TINY, net, "cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        scorer.score_device(chunks)
    names = [e.name for e in prof.events()]
    assert "fastdnn.output_chain" in scorer_mod.SPANS
    for name in ("fastdnn.score_device", "fastdnn.trunk_layers", "fastdnn.output_chain"):
        assert name in names


def test_the_random_net_keeps_every_layers_scale():
    """random_tdnnf_net's batchnorm statistics keep each layer's output rms
    within 0.25-4x of tdnn1's (the benchmark's draw holds the same rule)."""
    rng = np.random.default_rng(5)
    net = fdt.random_tdnnf_net(rng, 220, 256, 32, mt.LIBRISPEECH_STRIDES, 64, 500)
    x = torch.from_numpy(rng.standard_normal((2, 228, 220)).astype(np.float32))
    h = net.input_bn(torch.relu(x @ net.input_w + net.input_b))
    first = float(h.pow(2).mean().sqrt())
    for layer in net.layers:  # each layer at full rate with offsets of its stride
        s = layer.stride
        c = (h @ layer.linear[0] if s == 0 else
             mt._shift(h, -s) @ layer.linear[0] + h @ layer.linear[1])
        u = (c @ layer.affine[0] if s == 0 else c @ layer.affine[0]
             + mt._shift(c, s) @ layer.affine[1]) + layer.bias
        h = net.bypass_scale * h + layer.bn(torch.relu(u))
        assert 0.25 < float(h[:, 40:-40].pow(2).mean().sqrt()) / first < 4


def test_the_work_counts_equal_the_hand_counts():
    """run_tdnn_1d's needed rows a 150-frame chunk and about 3.07 G
    operations, 85% of them the factorized layers'."""
    rows = NETS.needed_rows(CONFIG, 150)
    assert rows["outputs"] == 50 and rows["input_rows"] == 226
    assert [r[1] for r in rows["layers"]][:5] == [224, 222, 74, 74, 72]
    assert [r[1] for r in rows["layers"]][-1] == 50
    work = NETS.work(CONFIG, {"frames": 64 * 150, "chunks": 64, "context_frames": 64 * 78,
                              "subsampled_rows": 64 * 50})
    per_chunk = sum(w.ops for w in work.values()) / 64
    assert per_chunk == pytest.approx(3.07e9, rel=0.01)
    assert work["trunk"].ops / (64 * per_chunk) == pytest.approx(0.85, abs=0.01)
    assert work["input_layer"].ops == pytest.approx(64 * 2 * 226 * 220 * 1536)
    assert work["input_layer"].precision == "tf32"
    assert work["output_dense"].ops == pytest.approx(64 * 50 * (6 * 1536 * 256 + 2 * 256 * 7000))
    # the f32 output rows bound the output stage
    assert work["output_dense"].bound_s == pytest.approx(work["output_dense"].bytes / 3.35e12)


HARNESS_RUN = """
import dataclasses, json, sys
sys.path.insert(0, "tests")
import torch
from benchmark import controls, run, spec
from test_torch_tdnnf import plant

torch.set_num_threads(2)  # beside the test workers' own threads
BENCH = spec.load()
CELL = spec.workload(BENCH, "tdnnf-chunks")
TINY = spec.net(spec.config(BENCH, CELL)).TINY


def tiny_run(seed=5, trace=False, build=None):
    return run.run_cell(BENCH, CELL, seed, 0.3, trace, "cpu", build=build,
                        config_overrides=TINY,
                        traffic_overrides={"chunks": {"chunks": 3, "batches": 2}})


def faulty(fault):
    def build(config, net, device):
        scorer = spec.net(config).build(config, net, device)
        scorer.net = plant(scorer.net, fault)
        return scorer
    return build


out = {"runs": [tiny_run(seed=2**33 + 7, trace=t) for t in (False, True)]}
for fault in ("bypass", "stride", "bn"):
    out[fault] = tiny_run(build=faulty(fault))
for variant in ("tf32", "bf16"):
    out[variant] = tiny_run(build=controls.system_for(variant))
try:
    tiny_run(build=controls.system_for("int4"))
except ValueError as e:
    out["int4"] = str(e)
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def harness():
    """The tdnnf-chunks cell at its net's TINY size (3 chunks a batch), as
    the harness's own tests run a cell: plain, traced, with each planted
    fault and each control; in a process of its own (a run gives no result
    in a process that loaded JAX, as this test process may have)."""
    out = subprocess.run([sys.executable, "-c", HARNESS_RUN], capture_output=True, text=True,
                         cwd=str(spec.ROOT), timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_the_harness_runs_the_tdnnf_net_at_its_tiny_size(harness):
    bench = spec.load()
    cell = spec.workload(bench, "tdnnf-chunks")
    assert spec.config(bench, cell)["net"] == "tdnnf"
    for trace, result in zip((False, True), harness["runs"]):
        assert result["correct"] and result["failed"] == 0 and result["attempted"] > 0
        expected = {m["name"] for m in spec.metrics(bench, cell, trace)}
        assert set(result["metrics"]) <= expected
        if not trace:
            assert set(result["metrics"]) == expected
        else:  # the host-side readings, the new span's among them
            assert "output_chain.host_ms_per_request" in result["metrics"]
            assert "trunk_layers.host_ms_per_request" in result["metrics"]


@pytest.mark.parametrize("fault", ["bypass", "stride", "bn"])
def test_planted_faults_read_as_not_correct_in_the_new_cell(harness, fault):
    assert harness[fault]["failed"] == 0 and not harness[fault]["correct"]


@pytest.mark.parametrize("variant", ["tf32", "bf16"])
def test_controls_read_as_not_correct_in_the_new_cell(harness, variant):
    value = harness[variant]["checks"]["worst_mean_row_l1"]
    assert not harness[variant]["correct"] and value["value"] > value["limit"]


def test_the_int4_control_does_not_apply(harness):
    """A TDNN-F net has no int4 form: the program refuses it at set-up."""
    assert "no int4 form" in harness["int4"]


# -- on the card -------------------------------------------------------------------

#: (chunks, rows) of the card's checks: the cell's batch and odd chunk counts
CARD_SHAPES = [(64, 228), (1, 228), (3, 228), (7, 231)]


def _codes(g, n, k):
    return (torch.randint(-127, 128, (n, k), generator=g, dtype=torch.int8),
            torch.rand(n, generator=g) * 0.05)


def _matrix(g, k, n, lo=-40):
    return torch.randint(lo, -lo + 1, (k, n), generator=g, dtype=torch.int8)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return lambda t: t.cuda() if isinstance(t, torch.Tensor) else t


@pytest.mark.cuda
@pytest.mark.parametrize("chunks, rows", CARD_SHAPES)
def test_k11_and_k12_are_their_plain_versions_bitwise(chunks, rows):
    """Both offsets' terms at full rate (offsets -1, 0 and 0, +1), the rate
    drop (stride 0, the map (rows / 3, rows, 0, 3)) with its bypass, at the
    published widths (1536, 160)."""
    d = _cuda()
    g = torch.Generator().manual_seed(rows + chunks)
    h, k = 1536, 160
    n = chunks * rows
    codes, scale = _codes(g, n, h)
    p = [_matrix(g, h, k, -20), _matrix(g, h, k, -20)]
    e = [_matrix(g, k, h), _matrix(g, k, h)]
    inv = [torch.tensor(1 / 900.0), torch.tensor(1 / 310.0)]
    bias, gamma, beta = torch.randn(h, generator=g), torch.rand(h, generator=g) + 0.5, \
        torch.randn(h, generator=g)
    factor = torch.tensor(0.66)
    low = rows // 3
    for row_map, n_out, offsets in (((1, 1, 0, 0), n, (-1, 0)),
                                    ((low, rows, 0, 3), chunks * low, (0,))):
        terms = [(codes, scale, p[i], inv[i], o) for i, o in enumerate(offsets)]
        want_c = plain.tdnnf_project_step(terms, n_out, row_map)
        kt = [(d(c), d(s), d(kernels.kernel_layout(w)), i, o) for c, s, w, i, o in terms]
        for wt in kt:
            kernels.check_tdnnf_matrix("tdnnf_project", wt[2], k_multiple=128, n_exact=160)
        got_c = kernels.tdnnf_project(kt, n_out, row_map)
        assert torch.equal(got_c[0].cpu(), want_c[0]) and torch.equal(got_c[1].cpu(), want_c[1])
        aff = [(want_c[0], want_c[1], e[i], inv[i], o) for i, o in enumerate((0, 1)[: len(offsets)])]
        by = (codes, scale, factor, row_map)
        want = plain.tdnnf_expand_step(aff, n_out, (1, 1, 0, 0), bias, gamma, beta, by)
        kaff = [(d(c), d(s), d(kernels.kernel_layout(w)), i, o) for c, s, w, i, o in aff]
        got = kernels.tdnnf_expand(kaff, n_out, (1, 1, 0, 0), d(bias), d(gamma), d(beta),
                                   (d(codes), d(scale), factor, row_map))
        assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("chunks", [64, 1, 3, 7])
def test_the_chain_kernels_are_their_plain_versions_bitwise(chunks):
    """prefinal-l through the outputs' row map, prefinal-chain's affine and
    its linear with a bias, the logits over 7,000 outputs."""
    d = _cuda()
    g = torch.Generator().manual_seed(chunks)
    h, p, n_out = 1536, 256, 7000
    codes, scale = _codes(g, chunks * 76, h)
    rows = chunks * 50
    select = (50, 76, 13, 1)
    inv = torch.tensor(1 / 700.0)
    lw, fw, l2w, ow = _matrix(g, h, p, -20), _matrix(g, p, h), _matrix(g, h, p, -20), \
        _matrix(g, p, n_out)
    vec = lambda n: torch.randn(n, generator=g)
    fb, ga, ba, b2, ob = vec(h), vec(h).abs() + 0.5, vec(h), vec(p), vec(n_out)
    t = lambda w: d(kernels.kernel_layout(w))
    want_g = plain.tdnnf_project_step([(codes, scale, lw, inv, 0)], rows, select)
    got_g = kernels.tdnnf_project([(d(codes), d(scale), t(lw), inv, 0)], rows, select, chain=True)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(got_g, want_g))
    want_v = plain.tdnnf_expand_step([(*want_g, fw, inv, 0)], rows, (1, 1, 0, 0), fb, ga, ba)
    got_v = kernels.tdnnf_expand([(d(want_g[0]), d(want_g[1]), t(fw), inv, 0)], rows,
                                 (1, 1, 0, 0), d(fb), d(ga), d(ba), chain=True)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(got_v, want_v))
    want_p = plain.tdnnf_project_step([(*want_v, l2w, inv, 0)], rows, bias=b2)
    got_p = kernels.tdnnf_project([(d(want_v[0]), d(want_v[1]), t(l2w), inv, 0)], rows,
                                  (1, 1, 0, 0), d(b2), chain=True)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(got_p, want_p))
    want_y = plain.chain_logits_step(*want_p, ow, inv, ob)
    got_y = kernels.chain_logits(d(want_p[0]), d(want_p[1]), t(ow), inv, d(ob))
    assert torch.equal(got_y.cpu(), want_y)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [64 * 228, 228, 3 * 228 + 5])
def test_tdnnf_input_is_its_plain_version_bitwise(rows):
    d = _cuda()
    g = torch.Generator().manual_seed(rows)
    x = torch.randn(rows, 220, generator=g)
    w = torch.randn(220, 1536, generator=g) * 220 ** -0.5
    b, gamma, beta = (torch.randn(1536, generator=g) * 0.1, torch.rand(1536, generator=g) + 1,
                      torch.randn(1536, generator=g) * 0.3)
    want = plain.tdnnf_input_step(x, w, b, gamma, beta)
    kernels.check_tdnnf_input(d(w), d(b), d(gamma), d(beta))
    got = kernels.tdnnf_input(d(x), d(w), d(b), d(gamma), d(beta))
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])


@pytest.mark.cuda
def test_score_device_runs_the_kernels_and_meets_the_plain_route():
    """The published widths on the card: 37 launches a call, and the chain
    output bitwise the plain route's."""
    _cuda()
    net = NETS.draw(CONFIG, SEED, "cuda")
    scorer = NETS.build(CONFIG, net, "cuda")
    chunks = _chunks(CONFIG, chunks=8).cuda()
    kernels.reset_launch_counts()
    got = scorer.score_device(chunks)
    counts = {k: v for k, v in kernels.launch_counts().items() if v}
    assert counts == {"tdnnf_input": 1, "tdnnf_project": 16, "tdnnf_expand": 16,
                      "chain_project": 2, "chain_expand": 1, "chain_logits": 1}
    want = NETS.build(CONFIG, net, "cuda", engine={"backend": "torch"}).score_device(chunks)
    assert got.shape == want.shape == (8, 50, 7000)
    assert torch.equal(got, want)

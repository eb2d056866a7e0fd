"""The input layer's precision knob (EngineConfig.input_precision) of the
PyTorch port against the JAX package, on CPU.

"high" and "highest" take the f64 product rounded once to f32 (the plain
version of K9, the 3xTF32 kernel), "default" rounds both operands to bf16
first (the plain version of K9's 1-pass bf16 variant).  The JAX package on
the CPU ignores `precision` (its three settings give bitwise the same
counts), so its oracle for "default" is the JAX function run on operands
already rounded to bf16 (`jnp.bfloat16` and back).  Bounds: input-layer
counts within 1 on at most 1e-4 of the entries (the f32 summation order);
posteriors within 1e-4 with argmax equal.  Where the question is whether a
path carries the knob, the port is held bitwise to itself fed the rounded
operands, and "default" must differ from "high".
"""

import dataclasses
import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import fastdnn_tpu as fd
import fastdnn_tpu_torch as fdt
from fastdnn_tpu.ops import matmul as jops
from fastdnn_tpu_torch.cli import serve
from fastdnn_tpu_torch.engine import scorer as tscorer
from fastdnn_tpu_torch.engine.backend import KERNELS
from fastdnn_tpu_torch.ops import kernels
from fastdnn_tpu_torch.ops import matmul as tops
from fastdnn_tpu_torch.parallel.mesh import make_mesh
from fastdnn_tpu_torch.parallel.sharded import make_gspmd_scorer, score_shard_map

COUNT_FLIP_RATE = 1e-4
POSTERIOR_ATOL = 1e-4
STREAM_ATOL = 1e-6  # the stream against serial calls, as tests/test_torch_stream.py
PRECISIONS = ("highest", "high", "default")
OUT = 1000

_jax_input_layer = jax.jit(jops.input_layer_step, static_argnums=3)


def _input_layer(rng, b, k, h):
    """Seeded frames f32 [b, k], a float input weight [k, h] scaled as
    random_net scales it, and its bias, as numpy."""
    frames = rng.standard_normal((b, k), dtype=np.float32)
    w = (rng.standard_normal((k, h), dtype=np.float32) * np.float32(k ** -0.5)).astype(np.float32)
    bias = (rng.standard_normal(h) * 0.1).astype(np.float32)
    return frames, w, bias


def _bf16(x) -> np.ndarray:
    """f32 -> the nearest bf16 (ties to even), back as f32, in JAX."""
    return np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))


def _assert_counts_close(got, want):
    d = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
    assert d.max() <= 1
    assert (d > 0).mean() <= COUNT_FLIP_RATE, f"{(d > 0).sum()} of {d.size} counts differ"


def _assert_close(got, want, atol=POSTERIOR_ATOL):
    assert got.shape == want.shape and got.dtype == np.float32 and np.isfinite(got).all()
    assert np.abs(got - want).max() <= atol
    np.testing.assert_array_equal(got.argmax(1), want.argmax(1))


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


def _input_net(w, bias, operand):
    """What the kernels' input layer reads of a prepared net."""
    return types.SimpleNamespace(input_w=w, input_b=bias, input_operand=operand)


# -- the input layer -------------------------------------------------------------


class TestInputLayer:
    @pytest.mark.parametrize("k", [432, 429, 40])
    @pytest.mark.parametrize("h", [128, 384])
    def test_default_matches_jax_on_rounded_operands(self, k, h):
        """The plain "default" version, its kernel's wrapper and the CUDA
        backend's step on CPU tensors against the JAX function on operands
        rounded to bf16."""
        frames, w, bias = _input_layer(np.random.default_rng(k * h), 2048, k, h)
        want = np.asarray(_jax_input_layer(_bf16(frames), _bf16(w), bias, "high"))
        x, w_t, b_t = _t(frames, w, bias)
        got = tops.input_layer_step(x, w_t, b_t, "default")
        assert got.dtype == torch.int8 and got.shape == (2048, h)
        _assert_counts_close(got.numpy(), want)
        operand = kernels.input_layer_operand(w_t, "default")
        assert torch.equal(kernels.input_layer_bf16(x, w_t, operand, b_t), got)
        assert torch.equal(KERNELS.input_layer(_input_net(w_t, b_t, operand), x, "default"), got)

    @pytest.mark.parametrize("precision", ["highest", "high"])
    @pytest.mark.parametrize("k", [432, 429, 40])
    def test_high_and_highest_match_jax(self, precision, k):
        frames, w, bias = _input_layer(np.random.default_rng(k + 1), 2048, k, 256)
        want = np.asarray(_jax_input_layer(frames, w, bias, precision))
        x, w_t, b_t = _t(frames, w, bias)
        got = tops.input_layer_step(x, w_t, b_t, precision)
        _assert_counts_close(got.numpy(), want)
        # both are today's f64 product, and K9 on CPU tensors takes it
        assert torch.equal(got, tops.input_layer_step(x, w_t, b_t))
        operand = kernels.input_layer_operand(w_t, precision)
        assert torch.equal(KERNELS.input_layer(_input_net(w_t, b_t, operand), x, precision), got)

    def test_default_rounds_both_operands(self):
        frames, w, bias = _input_layer(np.random.default_rng(3), 1024, 432, 256)
        x, w_t, b_t = _t(frames, w, bias)
        got = tops.input_layer_step(x, w_t, b_t, "default")
        rounded = tops.input_layer_step(*_t(_bf16(frames), _bf16(w)), b_t, "high")
        assert torch.equal(got, rounded)  # bf16 values round to themselves
        flipped = float((got != tops.input_layer_step(x, w_t, b_t, "high")).float().mean())
        assert 1e-3 < flipped < 0.5, flipped  # a 1-pass bf16 product moves some counts
        assert torch.equal(tops.bf16_round(x), torch.as_tensor(_bf16(frames)))

    @pytest.mark.parametrize("k", [432, 429, 40])
    def test_default_operand(self, k):
        """bf16 [H, K16]: w transposed, each value its nearest bf16, zero
        padding past K; "high" and "highest" keep K9's TF32 halves."""
        w = torch.as_tensor(np.random.default_rng(k).standard_normal((k, 256), dtype=np.float32))
        operand = kernels.input_layer_operand(w, "default")
        k16 = k + -k % kernels.INPUT_BF16_K_MULTIPLE
        assert operand.shape == (256, k16) and operand.dtype == torch.bfloat16
        assert operand.is_contiguous()
        assert bool((operand[:, k:] == 0).all())
        assert torch.equal(operand[:, :k].float(), torch.as_tensor(_bf16(w.numpy().T)))
        for precision in ("highest", "high"):
            assert torch.equal(kernels.input_layer_operand(w, precision),
                               kernels.input_layer_operand(w))

    def test_unknown_precision_raises(self):
        frames, w, bias = _t(*_input_layer(np.random.default_rng(4), 8, 32, 128))
        with pytest.raises(ValueError, match="input_precision"):
            tops.input_layer_step(frames, w, bias, "medium")
        with pytest.raises(ValueError, match="input_precision"):
            kernels.input_layer_operand(w, "medium")
        with pytest.raises(ValueError, match="input_precision"):
            KERNELS.input_layer(_input_net(w, bias, kernels.input_layer_operand(w)), frames, "bf16")
        q = fdt.quantize_net(fdt.random_net(np.random.default_rng(5), 32, [64], 64))
        with pytest.raises(ValueError, match="input_precision"):
            fdt.Scorer(q, fdt.EngineConfig(input_precision="medium"), device="cpu")
        with pytest.raises(SystemExit):
            serve.build_parser().parse_args(["m.npz", "--input-precision", "medium"])

    def test_the_kernel_has_its_own_launch_count(self):
        assert kernels.KERNELS["input_layer_bf16"].source == kernels.KERNELS["input_layer"].source
        assert "input_layer_bf16" in kernels.launch_counts()
        kernels.reset_launch_counts()
        frames, w, bias = _t(*_input_layer(np.random.default_rng(6), 8, 32, 128))
        kernels.input_layer_bf16(frames, w, kernels.input_layer_operand(w, "default"), bias)
        assert all(v == 0 for v in kernels.launch_counts().values())  # CPU: no launch


# -- the engine --------------------------------------------------------------------


def _carry(j_q, tmp_path):
    """A JAX QuantizedNet -> the port, through the checkpoint arrays."""
    fd.save_qnet(j_q, tmp_path / "q.npz")
    with np.load(tmp_path / "q.npz") as z:
        return fdt.qnet_from_arrays({k: np.asarray(z[k]) for k in z.files})


@pytest.fixture(scope="module")
def nets(tmp_path_factory):
    """(JAX net, port net, JAX net with its input weight rounded to bf16,
    port net with its input weight so rounded): 432 -> 3x256 -> 1000, one
    set of parameters."""
    t_net = fdt.random_net(np.random.default_rng(12), 432, [256, 256, 256], OUT)
    j_q = fd.quantize_net(fd.from_raw(fdt.to_raw(t_net)))
    j_r = dataclasses.replace(j_q, input_w=jnp.asarray(_bf16(j_q.input_w)))
    t_q = _carry(j_q, tmp_path_factory.mktemp("q"))
    t_r = dataclasses.replace(t_q, input_w=torch.as_tensor(_bf16(t_q.input_w.numpy())))
    return j_q, t_q, j_r, t_r


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(13)
    frames = rng.standard_normal((200, 432), dtype=np.float32)
    masks = (rng.random((200, OUT)) < 0.4).astype(np.uint8)
    masks[7] = 0
    return frames, masks


def _scorer(q, precision="high", **cfg):
    return fdt.Scorer(q, fdt.EngineConfig(input_precision=precision, **cfg), device="cpu")


@pytest.mark.parametrize("precision", PRECISIONS)
def test_scorer_matches_jax(nets, inputs, precision):
    """Scorer(device="cpu") under each precision against the JAX Scorer;
    for "default", JAX scores the rounded frames with the rounded input
    weight."""
    j_q, t_q, j_r, _ = nets
    frames, _ = inputs
    got = _scorer(t_q, precision).score(frames)
    if precision == "default":
        want = fd.Scorer(j_r, fd.EngineConfig(backend="xla")).score(_bf16(frames))
    else:
        want = fd.Scorer(j_q, fd.EngineConfig(backend="xla", input_precision=precision)).score(
            frames)
    _assert_close(got, want)


def test_default_knob_leaves_the_path_as_it_was(nets, inputs):
    """A config that leaves input_precision out, "high" and "highest" give
    bitwise the same posteriors; "default" moves them."""
    _, t_q, _, _ = nets
    frames, _ = inputs
    base = fdt.Scorer(t_q, fdt.EngineConfig(), device="cpu").score(frames)
    assert fdt.EngineConfig().input_precision == "high"
    for precision in ("high", "highest"):
        np.testing.assert_array_equal(_scorer(t_q, precision).score(frames), base)
    assert np.abs(_scorer(t_q, "default").score(frames) - base).max() > STREAM_ATOL


@pytest.mark.parametrize("semantics", ["reference", "active_only"])
def test_score_masked_carries_precision(nets, inputs, semantics):
    j_q, t_q, j_r, t_r = nets
    frames, masks = inputs
    got = _scorer(t_q, "default", lazy_semantics=semantics).score_masked(frames, masks)
    # bitwise the port fed the rounded operands
    np.testing.assert_array_equal(
        got, _scorer(t_r, lazy_semantics=semantics).score_masked(_bf16(frames), masks))
    want = fd.Scorer(j_r, fd.EngineConfig(backend="xla", lazy_semantics=semantics)).score_masked(
        _bf16(frames), masks)
    _assert_close(got, want)


def test_lazy_context_carries_precision(nets, inputs):
    _, t_q, _, t_r = nets
    frames, masks = inputs

    def decode(scorer, x):
        ctx = scorer.new_lazy_context(6)
        ctx.calculate_until_output(x[:6])
        return ctx._acts, np.stack([ctx.calculate_for_output_nodes(m) for m in masks[:6]])

    acts, rows = decode(_scorer(t_q, "default"), frames)
    acts_r, rows_r = decode(_scorer(t_r), _bf16(frames))
    assert torch.equal(acts, acts_r)
    np.testing.assert_array_equal(rows, rows_r)
    assert not torch.equal(acts, decode(_scorer(t_q), frames)[0])


def test_stream_carries_precision(nets, inputs):
    _, t_q, _, _ = nets
    frames, masks = inputs
    scorer = _scorer(t_q, "default")
    utts = [(frames[:37], None), (frames[37:120], masks[37:120]), (frames[120:], None)]
    with fdt.StreamingScorer(scorer, max_batch_frames=256, max_wait_ms=2.0) as stream:
        futures = [stream.submit(f, m) for f, m in utts]
        got = [f.result(60) for f in futures]
    high = _scorer(t_q)
    moved = 0.0
    for (f, m), g in zip(utts, got):
        want = scorer.score(f) if m is None else scorer.score_masked(f, m)
        np.testing.assert_allclose(g, want, atol=STREAM_ATOL)
        other = high.score(f) if m is None else high.score_masked(f, m)
        moved = max(moved, float(np.abs(g - other).max()))
    assert moved > STREAM_ATOL  # the stream scored under "default", not "high"


def test_hidden_forward_picks_the_input_route(nets, inputs):
    """Both backends' steps under each precision, on CPU tensors (where the
    kernel wrappers take their plain versions): the CUDA backend's net is
    prepared for the precision, and its activations equal the plain
    backend's."""
    _, t_q, _, t_r = nets
    x = torch.as_tensor(inputs[0][:64])
    want = {p: tscorer.hidden_forward(t_q, x, "torch", input_precision=p) for p in PRECISIONS}
    assert torch.equal(want["high"], want["highest"])
    assert not torch.equal(want["high"], want["default"])
    assert torch.equal(want["default"],
                       tscorer.hidden_forward(t_r, torch.as_tensor(_bf16(x)), "torch"))
    for p in PRECISIONS:
        prepared = KERNELS.prepare(t_q, "cpu", input_precision=p)
        assert prepared.input_operand.dtype == (torch.bfloat16 if p == "default"
                                                else torch.float32)
        assert torch.equal(tscorer.hidden_forward(prepared, x, "cuda", input_precision=p),
                           want[p])


def test_mesh_programs_carry_precision(nets, inputs, tmp_path):
    """A one-rank gloo group: Scorer(mesh=...), MultiHostScorer,
    make_gspmd_scorer and score_shard_map under "default" against the
    single-device Scorer."""
    from fastdnn_tpu_torch.parallel.service import MultiHostScorer

    _, t_q, _, _ = nets
    frames, masks = inputs
    want = _scorer(t_q, "default").score(frames)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rendezvous'}",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh(1, 1, device_type="cpu")
        cfg = fdt.EngineConfig(input_precision="default")
        np.testing.assert_array_equal(fdt.Scorer(t_q, cfg, device="cpu", mesh=mesh).score(frames),
                                      want)
        mh = MultiHostScorer(t_q, cfg, mesh, device="cpu", heartbeat_s=0)
        np.testing.assert_array_equal(mh.score(frames), want)
        np.testing.assert_array_equal(
            mh.score_masked(frames, masks), _scorer(t_q, "default").score_masked(frames, masks))
        mh.close()
        x = torch.as_tensor(frames)
        score, _ = make_gspmd_scorer(mesh, backend="torch", input_precision="default")
        _assert_close(score(t_q, x).numpy(), want, STREAM_ATOL)
        shard = score_shard_map(t_q, x, mesh, input_precision="default")[:, :OUT].numpy()
        _assert_close(shard, want, STREAM_ATOL)
        high = score_shard_map(t_q, x, mesh)[:, :OUT].numpy()
        assert np.abs(high - shard).max() > STREAM_ATOL
    finally:
        dist.destroy_process_group()


def test_serve_builds_the_serving_configuration(nets, inputs, tmp_path):
    """`--input-precision default --fast-posteriors`, the JAX package's
    documented serving configuration, reaches the Scorer, and a server so
    built answers as the in-process Scorer does."""
    j_q, t_q, _, _ = nets
    frames, _ = inputs
    fd.save_qnet(j_q, tmp_path / "q.npz")
    args = serve.build_parser().parse_args(
        [str(tmp_path / "q.npz"), "--device", "cpu", "--port", "0", "--input-precision",
         "default", "--fast-posteriors", "--max-batch-frames", "256"])
    server = serve.make_server(args)
    scorer = server.stream._scorer
    assert scorer.config.input_precision == "default" and scorer.config.fast_posteriors

    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        client = serve.ScoreClient(*server.server_address[:2])
        got = client.score(frames[:50])
        client.close()
    finally:
        server.shutdown()
        server.server_close()
        server.stream.close()
    thread.join(30)
    want = _scorer(t_q, "default", fast_posteriors=True).score(frames[:50])
    np.testing.assert_allclose(got, want, atol=STREAM_ATOL)


# -- on the card -----------------------------------------------------------------


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py phase 29 runs the same checks on the card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_bf16_kernel_matches_plain_on_card(cuda_device):
    rng = np.random.default_rng(29)
    for b, k, h in ((320, 432, 384), (320, 429, 384), (1, 432, 256), (192, 96, 128)):
        frames, w, bias = (torch.as_tensor(a).to(cuda_device) for a in _input_layer(rng, b, k, h))
        kernels.reset_launch_counts()
        got = kernels.input_layer_bf16(frames, w, kernels.input_layer_operand(w, "default"), bias)
        assert kernels.launch_counts()["input_layer_bf16"] == 1
        want = tops.input_layer_step(frames, w, bias, "default")
        _assert_counts_close(got.cpu().numpy(), want.cpu().numpy())

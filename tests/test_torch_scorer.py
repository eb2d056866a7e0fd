"""The PyTorch port's slice as a whole, against the JAX package, on CPU.

A JAX-quantized net crosses to the port as the arrays `save_qnet` writes, so
both packages score with identical parameters.  Bounds:
  * from identical first-layer int8 activations: the trunk is bitwise equal
    and the posteriors agree to 3e-5 (softmax reduction order);
  * from frames: first-layer counts may differ by 1 on at most 1e-4 of the
    entries (f32 summation order of the float input layer), posteriors
    agree to 1e-4 with at least 99.9% argmax agreement.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import fastdnn_tpu as fd
import fastdnn_tpu_torch as fdt
from fastdnn_tpu.cli import score as jcli
from fastdnn_tpu.engine import scorer as jscorer
from fastdnn_tpu.ops import matmul as jops
from fastdnn_tpu_torch.cli import score as tcli
from fastdnn_tpu_torch.engine.backend import KERNELS
from fastdnn_tpu_torch.ops import kernels
from fastdnn_tpu_torch.ops import matmul as tops

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOFTMAX_ATOL = 3e-5
POSTERIOR_ATOL = 1e-4
ARGMAX_AGREEMENT = 0.999
COUNT_FLIP_RATE = 1e-4


def _nets(seed, out):
    """(port float net, JAX float net) with identical weights."""
    t_net = fdt.random_net(np.random.default_rng(seed), 432, [256, 256, 256], out)
    return t_net, fd.from_raw(fdt.to_raw(t_net))


def _carry(j_q, tmp_path):
    """A JAX QuantizedNet -> the port, through the checkpoint arrays."""
    fd.save_qnet(j_q, tmp_path / "q.npz")
    with np.load(tmp_path / "q.npz") as z:
        return fdt.qnet_from_arrays({k: np.asarray(z[k]) for k in z.files})


def _frames(seed, n):
    return np.random.default_rng(seed).standard_normal((n, 432), dtype=np.float32)


@pytest.fixture(scope="module", params=[400, 1000])
def nets(request, tmp_path_factory):
    _, j_net = _nets(request.param, request.param)
    j_q = fd.quantize_net(j_net)
    return j_q, _carry(j_q, tmp_path_factory.mktemp("q"))


def test_trunk_bitwise_and_posteriors_from_identical_first_layer(nets):
    j_q, t_q = nets
    frames = _frames(1, 512)
    acts0 = np.array(jax.jit(jops.input_layer_step)(frames, j_q.input_w, j_q.input_b))
    step = jax.jit(jops.hidden_layer_step)
    j_acts = acts0
    for i in range(len(j_q.weights) - 1):
        j_acts = step(j_acts, j_q.weights[i], j_q.colsum128[i], j_q.inv_scales[i], j_q.biases[i])
    j_acts = np.asarray(j_acts)
    pallas_stack = jscorer.build_hidden_stack(j_q)
    from fastdnn_tpu.engine import pallas_backend

    j_pallas = np.asarray(pallas_backend.hidden_stack_step(acts0, pallas_stack, interpret=True))

    a0 = torch.as_tensor(acts0)
    t_stack = tops.hidden_stack_step(a0, fdt.build_hidden_stack(t_q))
    t_layers = a0
    for i in range(len(t_q.weights) - 1):
        t_layers = tops.hidden_layer_step(
            t_layers, t_q.weights[i], t_q.colsum128[i], t_q.inv_scales[i], t_q.biases[i]
        )
    np.testing.assert_array_equal(t_stack.numpy(), j_acts)
    np.testing.assert_array_equal(t_layers.numpy(), j_acts)
    np.testing.assert_array_equal(t_stack.numpy(), j_pallas)

    out = (j_q.weights[-1], j_q.colsum128[-1], j_q.inv_scales[-1], j_q.biases[-1])
    j_post = np.asarray(jax.nn.softmax(jax.jit(jops.output_logits)(j_acts, *out), axis=-1))
    t_out = (t_q.weights[-1], t_q.colsum128[-1], t_q.inv_scales[-1], t_q.biases[-1])
    t_post = tops.output_posteriors(t_stack, *t_out, out_dim=t_q.output_dim).numpy()
    np.testing.assert_allclose(t_post, j_post, rtol=0, atol=SOFTMAX_ATOL)
    np.testing.assert_array_equal(t_post.argmax(1), j_post.argmax(1))


def test_first_layer_counts_differ_rarely_and_by_one(nets):
    j_q, t_q = nets
    frames = _frames(2, 2048)
    j_acts = np.asarray(jax.jit(jops.input_layer_step)(frames, j_q.input_w, j_q.input_b))
    t_acts = tops.input_layer_step(torch.as_tensor(frames), t_q.input_w, t_q.input_b).numpy()
    d = np.abs(j_acts.astype(np.int32) - t_acts.astype(np.int32))
    assert d.max() <= 1
    assert (d > 0).mean() <= COUNT_FLIP_RATE, f"{(d > 0).sum()} of {d.size} counts differ"


@pytest.mark.parametrize("backend_kw", [
    dict(backend="xla"),
    dict(backend="pallas", interpret=True),
], ids=["xla", "pallas-interpret"])
def test_scorer_from_frames_matches_jax(nets, backend_kw):
    j_q, t_q = nets
    frames = _frames(3, 1000)  # buckets to 1024: stack path
    want = fd.Scorer(j_q, fd.EngineConfig(**backend_kw)).score(frames)
    scorer = fdt.Scorer(t_q, device="cpu")
    assert scorer.backend == "torch" and scorer.output_dim == j_q.output_dim
    got = scorer.score(frames)
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= POSTERIOR_ATOL
    assert (got.argmax(1) == want.argmax(1)).mean() >= ARGMAX_AGREEMENT
    np.testing.assert_allclose(got.sum(axis=1), 1.0, rtol=0, atol=1e-5)


def test_stack_and_per_layer_paths_agree(nets):
    _, t_q = nets
    frames = _frames(4, 300)
    stacked = fdt.Scorer(t_q, device="cpu").score(frames)
    per_layer = fdt.Scorer(t_q, fdt.EngineConfig(stack_hidden_max_frames=0), device="cpu")
    np.testing.assert_array_equal(per_layer.score(frames), stacked)


def test_prepared_net_carries_the_input_operand(nets):
    """The kernels' backend's prepare adds the input kernel's TF32 operand
    and keeps input_w; the CUDA backend's trunk, on CPU tensors (its
    wrappers' plain versions), equals the plain backend's."""
    _, t_q = nets
    prepared = KERNELS.prepare(t_q, "cpu")
    assert t_q.input_operand is None
    assert torch.equal(prepared.input_w, fdt.pad_qnet(t_q).input_w)
    assert torch.equal(prepared.input_operand, kernels.input_layer_operand(prepared.input_w))
    assert prepared.to("cpu").input_operand is not None
    frames = torch.as_tensor(_frames(10, 128))
    np.testing.assert_array_equal(
        fdt.hidden_forward(prepared, frames, "cuda")[:, :256].numpy(),
        fdt.hidden_forward(t_q, frames, "torch").numpy(),
    )


def test_score_device_and_edge_cases(nets):
    _, t_q = nets
    scorer = fdt.Scorer(t_q, device="cpu")
    frames = _frames(5, 128)
    on_device = scorer.score_device(torch.as_tensor(frames))
    np.testing.assert_array_equal(on_device.numpy(), scorer.score(frames))
    assert scorer.score(np.zeros((0, 432), np.float32)).shape == (0, t_q.output_dim)
    narrow = scorer.score(frames[:, :429])  # zero-padded up to the input dim
    wide = frames.copy()
    wide[:, 429:] = 0
    np.testing.assert_array_equal(narrow, scorer.score(wide))
    with pytest.raises(ValueError):
        scorer.score(np.zeros((4, 500), np.float32))
    with pytest.raises(ValueError):
        scorer.score_device(torch.zeros((4, 432), dtype=torch.float64))


def test_cli_matches_jax_cli(tmp_path):
    t_net, _ = _nets(6, 400)
    fd.write_model(fdt.to_raw(t_net), tmp_path / "model.bin")  # the JAX package's writer
    fd.write_features(_frames(6, 700), tmp_path / "feats.bin")
    assert jcli.main([str(tmp_path / "model.bin"), str(tmp_path / "feats.bin"),
                      str(tmp_path / "jax.bin"), "BIN", "--backend", "xla"]) == 0
    proc = subprocess.run(
        [sys.executable, "-m", "fastdnn_tpu_torch.cli.score", str(tmp_path / "model.bin"),
         str(tmp_path / "feats.bin"), str(tmp_path / "port.bin"), "BIN", "--device", "cpu"],
        capture_output=True, text=True, cwd=REPO, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert "Network     = 432-2x256-400" in proc.stdout  # the reference's (layers - 2)x form
    want = fd.read_features(tmp_path / "jax.bin")
    got = fdt.read_features(tmp_path / "port.bin")
    assert got.shape == want.shape == (700, 400)
    assert np.abs(got - want).max() <= POSTERIOR_ATOL
    assert (got.argmax(1) == want.argmax(1)).mean() >= ARGMAX_AGREEMENT


def test_cli_npz_checkpoint_and_text_output(tmp_path, nets, capsys):
    j_q, _ = nets
    fd.save_qnet(j_q, tmp_path / "q.npz")
    fd.write_features(_frames(7, 50), tmp_path / "feats.bin")
    assert tcli.main([str(tmp_path / "q.npz"), str(tmp_path / "feats.bin"),
                      str(tmp_path / "out.txt"), "TXT", "--device", "cpu"]) == 0
    rows = np.loadtxt(tmp_path / "out.txt", ndmin=2)
    assert rows.shape == (50, j_q.output_dim)
    assert "(int8 checkpoint)" in capsys.readouterr().out


class TestGuards:
    def test_port_imports_and_scores_with_jax_blocked(self):
        code = (
            "import sys\n"
            "for m in ('jax', 'jaxlib', 'ml_dtypes'): sys.modules[m] = None\n"
            "import numpy as np, fastdnn_tpu_torch as fdt\n"
            "q = fdt.quantize_net(fdt.random_net(np.random.default_rng(0), 40, [32, 32], 10))\n"
            "p = fdt.Scorer(q, device='cpu').score(np.ones((5, 40), np.float32))\n"
            "assert p.shape == (5, 10) and abs(p.sum() - 5) < 1e-4\n"
            "assert not any(m == 'fastdnn_tpu' or m.startswith(('fastdnn_tpu.', 'jax'))\n"
            "               for m in sys.modules if sys.modules[m] is not None)\n"
            "print('ok')\n"
        )
        proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                              cwd=REPO, timeout=300)
        assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr

    def test_no_jax_in_port_sources(self):
        root = os.path.join(REPO, "fastdnn_tpu_torch")
        for dirpath, dirs, files in os.walk(root):
            if "_build" in dirs:
                dirs.remove("_build")  # kernel build output, not sources
            for name in files:
                if name.endswith(".py"):
                    text = open(os.path.join(dirpath, name)).read()
                    for banned in ("import jax", "from jax", "ml_dtypes", "import fastdnn_tpu\n",
                                   "from fastdnn_tpu."):
                        assert banned not in text, f"{name}: {banned!r}"

    def test_cuda_device_without_cuda_raises(self, nets, monkeypatch):
        _, t_q = nets
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fdt.Scorer(t_q)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fdt.Scorer(t_q, device="cuda")

    def test_cuda_backend_on_cpu_raises(self, nets):
        _, t_q = nets
        with pytest.raises(ValueError, match="backend='cuda'"):
            fdt.Scorer(t_q, fdt.EngineConfig(backend="cuda"), device="cpu")

    def test_cli_device_cuda_without_cuda_fails(self, tmp_path, monkeypatch, capsys):
        t_net, _ = _nets(8, 20)
        fdt.write_model(fdt.to_raw(t_net), tmp_path / "model.bin")
        fdt.write_features(_frames(8, 10), tmp_path / "feats.bin")
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        assert tcli._cli([str(tmp_path / "model.bin"), str(tmp_path / "feats.bin")]) == 2
        assert "CUDA is not available" in capsys.readouterr().err


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs the same checks on the card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_cuda_scorer_matches_plain_scorer_on_card(nets, cuda_device):
    _, t_q = nets
    frames = _frames(9, 1000)
    want = fdt.Scorer(t_q, fdt.EngineConfig(backend="torch"), device=cuda_device).score(frames)
    scorer = fdt.Scorer(t_q, device=cuda_device)
    assert scorer.backend == "cuda"
    got = scorer.score(frames)
    # from frames: the input kernel's counts may differ by 1, rarely
    assert np.abs(got - want).max() <= POSTERIOR_ATOL
    assert (got.argmax(1) == want.argmax(1)).mean() >= ARGMAX_AGREEMENT

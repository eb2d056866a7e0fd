"""Parity of the PyTorch port's kernel modules with the JAX package, on CPU.

The same seeded inputs go through the JAX function (the jitted XLA op, and
the Pallas kernel in interpret mode) and through the port's counterpart
(the plain PyTorch version, which is what a kernel wrapper runs for a CPU
tensor).  Integer outputs must be bitwise equal; posteriors agree to 3e-5,
the softmax reduction-order bound the JAX package holds Pallas to.
"""

import jax
import numpy as np
import pytest
import torch

from fastdnn_tpu.ops import matmul as jops
from fastdnn_tpu.ops import pallas_kernels as pk
from fastdnn_tpu.ops import sigmoid as jsig
from fastdnn_tpu_torch.ops import _build, kernels
from fastdnn_tpu_torch.ops import matmul as tops
from fastdnn_tpu_torch.ops import sigmoid as tsig

SOFTMAX_ATOL = 3e-5
#: the input layer's count gate (ROADMAP C): s8 within 1, on at most 1e-4
#: of the entries, of the f64 product rounded once to f32
COUNT_FLIP_RATE = 1e-4


def _layer(rng, b, k, n):
    """Seeded int8 activations, int8 weights, colsum128, f32 inv scale and
    bias, as numpy."""
    x = rng.integers(-128, 128, (b, k), dtype=np.int8)
    w = rng.integers(-127, 128, (k, n), dtype=np.int8)
    colsum = 128 * w.astype(np.int32).sum(axis=0, dtype=np.int32)
    inv = np.float32(1.0 / (rng.integers(20, 60) * 255.0))
    bias = (rng.standard_normal(n) * 0.5).astype(np.float32)
    return x, w, colsum, inv, bias


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


def _input_layer(rng, b, k, h):
    """Seeded frames f32 [b, k], a float input weight [k, h] scaled as
    random_net scales it, and its bias, as numpy."""
    frames = rng.standard_normal((b, k), dtype=np.float32)
    w = (rng.standard_normal((k, h), dtype=np.float32) * np.float32(k ** -0.5)).astype(np.float32)
    bias = (rng.standard_normal(h) * 0.1).astype(np.float32)
    return frames, w, bias


def _assert_counts_close(got, want):
    """s8 counts within 1 of `want`, on at most COUNT_FLIP_RATE of the
    entries."""
    d = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
    assert d.max() <= 1
    assert (d > 0).mean() <= COUNT_FLIP_RATE, f"{(d > 0).sum()} of {d.size} counts differ"


def _three_term_input_layer(frames, w, bias):
    """A CPU model of K9's arithmetic (csrc/input_layer.cu), a test helper:
    the frames split into TF32 halves, the weight as input_layer_operand
    gives it, the three products a_lo W_hi + a_hi W_lo + a_hi W_hi of each
    32-deep stage summed exactly and rounded once to f32, the stages added
    into an f32 sum, then the bias and the quantized sigmoid."""
    x = torch.as_tensor(frames)
    operand = kernels.input_layer_operand(torch.as_tensor(w))
    k4 = operand.shape[2]
    x = torch.nn.functional.pad(x, (0, k4 - x.shape[1]))
    x_hi = kernels.tf32_round(x)
    x_lo = kernels.tf32_round(x - x_hi)
    w_hi, w_lo = (t.t().double() for t in operand)
    total = torch.zeros((x.shape[0], operand.shape[1]), dtype=torch.float32)
    for k0 in range(0, k4, 32):
        ks = slice(k0, k0 + 32)
        part = (x_lo[:, ks].double() @ w_hi[ks] + x_hi[:, ks].double() @ w_lo[ks]
                + x_hi[:, ks].double() @ w_hi[ks])
        total = total + part.float()
    return tsig.quantized_sigmoid_shifted_i8(total + torch.as_tensor(bias))


class TestSigmoid:
    def test_table_inputs_bitwise(self):
        x = (np.arange(-640, 641) / 100.0).astype(np.float32)
        ours = tsig.quantized_sigmoid_shifted_i8(torch.as_tensor(x)).numpy()
        jaxs = np.asarray(jax.jit(jsig.quantized_sigmoid_shifted_i8)(x))
        lut = tsig.reference_lut_lookup(x).astype(np.int32) - 128
        np.testing.assert_array_equal(ours, jaxs)
        np.testing.assert_array_equal(ours.astype(np.int32), lut)
        u8 = tsig.quantized_sigmoid_u8(torch.as_tensor(x)).numpy()
        np.testing.assert_array_equal(u8, np.asarray(jax.jit(jsig.quantized_sigmoid_u8)(x)))
        np.testing.assert_array_equal(u8, tsig.reference_lut_lookup(x))

    def test_random_inputs_bitwise(self):
        rng = np.random.default_rng(3)
        x = np.concatenate([
            rng.uniform(-8, 8, 90_000),
            (rng.integers(-700, 700, 10_000) + 0.5) / 100.0,  # half-step boundaries
        ]).astype(np.float32)
        ours = tsig.quantized_sigmoid_shifted_i8(torch.as_tensor(x)).numpy()
        np.testing.assert_array_equal(
            ours, np.asarray(jax.jit(jsig.quantized_sigmoid_shifted_i8)(x))
        )
        np.testing.assert_array_equal(
            ours.astype(np.int32), tsig.reference_lut_lookup(x).astype(np.int32) - 128
        )

    def test_lut_is_the_jax_packages(self):
        np.testing.assert_array_equal(tsig.build_reference_lut(), jsig.build_reference_lut())

    def test_bias_sigmoid_wrapper_on_cpu(self):
        rng = np.random.default_rng(4)
        lin = rng.uniform(-7, 7, (64, 96)).astype(np.float32)
        bias = rng.standard_normal(96).astype(np.float32)
        ours = kernels.bias_sigmoid_i8(*_t(lin, bias)).numpy()
        want = np.asarray(jax.jit(lambda a, b: jsig.quantized_sigmoid_shifted_i8(a + b))(lin, bias))
        np.testing.assert_array_equal(ours, want)


class TestInputLayer:
    """K9's wrapper on CPU tensors (its plain version), its TF32 operand,
    and a CPU model of its three-term product, against the JAX package's
    jitted input layer."""

    @pytest.mark.parametrize("k", [432, 429, 40])
    @pytest.mark.parametrize("h", [128, 384])
    def test_wrapper_on_cpu_matches_jax(self, k, h):
        rng = np.random.default_rng(k + h)
        frames, w, bias = _input_layer(rng, 2048, k, h)
        want = np.asarray(jax.jit(jops.input_layer_step)(frames, w, bias))
        w_t = torch.as_tensor(w)
        operand = kernels.input_layer_operand(w_t)
        assert operand.shape == (2, h, k + -k % kernels.INPUT_K_MULTIPLE)
        got = kernels.input_layer(torch.as_tensor(frames), w_t, operand, torch.as_tensor(bias))
        assert got.dtype == torch.int8 and got.shape == (2048, h)
        _assert_counts_close(got.numpy(), want)

    def test_tf32_operand(self):
        rng = np.random.default_rng(12)
        w = torch.as_tensor(rng.standard_normal((429, 256), dtype=np.float32) * 3)
        operand = kernels.input_layer_operand(w)
        assert operand.shape == (2, 256, 432) and operand.dtype == torch.float32
        assert bool((operand[:, :, 429:] == 0).all())
        for half in operand:
            assert bool(((half.view(torch.int32) & 0x1FFF) == 0).all())
        rebuilt = (operand[0] + operand[1])[:, :429].t().double()
        rel = ((rebuilt - w.double()).abs() / w.double().abs().clamp(min=1e-30)).max()
        assert float(rel) <= 2.0 ** -21
        # ties round away from zero, as cvt.rna.tf32.f32 does
        x = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 2 ** -12, 3.0], dtype=torch.float32)
        want = torch.tensor([1 + 2 ** -10, -(1 + 2 ** -10), 1.0, 3.0], dtype=torch.float32)
        assert torch.equal(kernels.tf32_round(x), want)

    def test_three_term_model_matches_jax(self):
        rng = np.random.default_rng(13)
        frames, w, bias = _input_layer(rng, 2048, 432, 2048)
        want = np.asarray(jax.jit(jops.input_layer_step)(frames, w, bias))
        _assert_counts_close(_three_term_input_layer(frames, w, bias).numpy(), want)


class TestHiddenLayer:
    @pytest.mark.parametrize("b,k,n", [(256, 256, 256), (64, 384, 128), (128, 384, 640),
                                       (64, 640, 256)])
    def test_matches_xla_and_pallas(self, b, k, n):
        rng = np.random.default_rng(b + k + n)
        x, w, colsum, inv, bias = _layer(rng, b, k, n)
        xla = np.asarray(jax.jit(jops.hidden_layer_step)(x, w, colsum, inv, bias))
        pallas = np.asarray(pk.fused_hidden_layer(x, w, colsum, inv, bias, interpret=True))
        w_t = kernels.kernel_layout(torch.as_tensor(w))
        ours = kernels.hidden_layer(torch.as_tensor(x), w_t, torch.as_tensor(colsum), float(inv),
                                    torch.as_tensor(bias)).numpy()
        np.testing.assert_array_equal(ours, xla)
        np.testing.assert_array_equal(ours, pallas)

    def test_int8_matmul_is_exact(self):
        rng = np.random.default_rng(5)
        a = rng.integers(-128, 128, (40, 2048), dtype=np.int8)
        w = rng.integers(-128, 128, (2048, 24), dtype=np.int8)
        want = a.astype(np.int64) @ w.astype(np.int64)
        np.testing.assert_array_equal(tops.int8_matmul(*_t(a, w)).numpy(), want)

    def test_stack_matches_pallas_stack(self):
        rng = np.random.default_rng(6)
        b, h, layers = 256, 256, 3
        x = rng.integers(-128, 128, (b, h), dtype=np.int8)
        parts = [_layer(rng, b, h, h)[1:] for _ in range(layers)]
        w = np.stack([p[0] for p in parts])
        colsum = np.stack([p[1] for p in parts])
        inv = np.array([p[2] for p in parts], np.float32)
        bias = np.stack([p[3] for p in parts])
        pallas = np.asarray(pk.fused_hidden_stack(x, w, colsum, inv, bias, interpret=True))
        xla = x
        for i in range(layers):
            xla = jax.jit(jops.hidden_layer_step)(xla, w[i], colsum[i], inv[i], bias[i])
        w_t = kernels.kernel_layout(torch.as_tensor(w))
        ours = kernels.hidden_stack(torch.as_tensor(x), w_t, *_t(colsum, inv, bias)).numpy()
        np.testing.assert_array_equal(ours, pallas)
        np.testing.assert_array_equal(ours, np.asarray(xla))


class TestResidentSoftmax:
    @pytest.mark.parametrize("out_dim", [1000, 1024])
    def test_matches_pallas_resident(self, out_dim):
        rng = np.random.default_rng(out_dim)
        x, w, colsum, inv, bias = _layer(rng, 128, 256, 1024)
        w[:, out_dim:] = 0  # padding columns as pad_qnet leaves them
        colsum[out_dim:] = 0
        bias[out_dim:] = 0
        pallas = np.asarray(pk.output_layer_posteriors_resident(
            x, w, colsum, inv, bias, out_dim=out_dim, interpret=True
        ))
        logits = jax.jit(jops.output_logits)(x, w, colsum, inv, bias)[:, :out_dim]
        xla = np.asarray(jax.nn.softmax(logits, axis=-1))
        ours = kernels.resident_softmax(
            torch.as_tensor(x), kernels.kernel_layout(torch.as_tensor(w)), torch.as_tensor(colsum),
            float(inv), torch.as_tensor(bias), out_dim=out_dim,
        ).numpy()
        assert ours.shape == (128, out_dim) and ours.dtype == np.float32
        np.testing.assert_allclose(ours, pallas, rtol=0, atol=SOFTMAX_ATOL)
        np.testing.assert_allclose(ours, xla, rtol=0, atol=SOFTMAX_ATOL)
        np.testing.assert_allclose(ours.sum(axis=1), 1.0, rtol=0, atol=1e-5)
        np.testing.assert_array_equal(ours.argmax(1), pallas.argmax(1))

    def test_padding_columns_never_count(self):
        """Nonzero logits in padding columns (a net padded by hand) still
        stay out of the softmax."""
        rng = np.random.default_rng(8)
        x, w, colsum, inv, bias = _layer(rng, 64, 128, 256)
        full = tops.output_posteriors(*_t(x, w, colsum), float(inv), torch.as_tensor(bias),
                                      out_dim=200)
        cut = tops.output_posteriors(
            *_t(x, w[:, :200].copy(), colsum[:200].copy()), float(inv),
            torch.as_tensor(bias[:200].copy()), out_dim=200,
        )
        np.testing.assert_allclose(full.numpy(), cut.numpy(), rtol=0, atol=1e-7)


class TestWrappers:
    def test_cpu_tensors_take_the_plain_versions(self):
        assert set(kernels.KERNELS) == set(kernels.launch_counts())
        kernels.reset_launch_counts()
        rng = np.random.default_rng(9)
        x, w, colsum, inv, bias = _layer(rng, 64, 128, 128)
        kernels.hidden_layer(*_t(x, w.T.copy(), colsum), float(inv), torch.as_tensor(bias))
        assert all(v == 0 for v in kernels.launch_counts().values())

    def test_nvcc_command(self, tmp_path):
        for src in _build.sources():
            cmd = _build.nvcc_command("nvcc", src, tmp_path / f"{src.stem}.o")
            assert "arch=compute_90a,code=sm_90a" in cmd
            assert "-fmad=false" in cmd and "-c" in cmd and str(src) in cmd
            assert not any("fast_math" in c or "fast-math" in c for c in cmd)
        link = _build.link_command("nvcc", [tmp_path / "a.o"], tmp_path / "lib.so")
        assert "-shared" in link and str(tmp_path / "lib.so") in link
        assert {p.name for p in _build.sources()} == {
            k.source.rsplit("/", 1)[1] for k in kernels.KERNELS.values()
        }
        assert _build.library_path().parent == _build.BUILD_DIR

    def test_library_hash_covers_the_headers(self):
        names = {p.name for p in _build.CSRC.iterdir() if p.suffix == ".cuh"}
        assert {"common.cuh", "hopper.cuh", "row_stats.cuh"} <= names
        for src in ("hidden_layer.cu", "hidden_stack.cu", "input_layer.cu", "resident_softmax.cu",
                    "hidden_layer_packed.cu", "output_logits.cu", "flash_stats.cu"):
            assert '#include "hopper.cuh"' in (_build.CSRC / src).read_text()
        for src in ("resident_softmax.cu", "flash_stats.cu"):
            assert '#include "row_stats.cuh"' in (_build.CSRC / src).read_text()
        # the retired mma.sync engine is gone from every source
        for path in _build.CSRC.iterdir():
            text = path.read_text()
            assert "mma.sync" not in text and "ldmatrix" not in text, path.name

    def test_sources_note_what_they_replace(self):
        for k in kernels.KERNELS.values():
            text = (_build.CSRC / k.source.rsplit("/", 1)[1]).read_text()
            assert "Replaces" in text and "fastdnn_tpu/ops/pallas_kernels.py" in text
            assert "Bound:" in text


class TestLoops:
    """The Python side of the wgmma kernels' launches: the weight's
    alignment, and the cluster size a K2, K3 or K7 launch gets."""

    @pytest.mark.parametrize("frames,want", [
        (8192, 2), (8320, 2), (128, 2), (256, 2), (384, 2), (64, 1), (192, 1), (320, 1),
        (960, 1), (8128, 1),
    ])
    def test_cluster_divides_the_frame_blocks(self, frames, want):
        assert kernels.wgmma_cluster(frames) == want
        assert (frames // kernels.HIDDEN_STACK_FRAMES) % want == 0

    def test_default_cluster(self):
        assert kernels.WGMMA_CLUSTER == 2
        assert kernels.wgmma_cluster(8192) == kernels.WGMMA_CLUSTER

    def test_launch_checks(self):
        w = torch.zeros(1024 + 16, dtype=torch.int8)
        kernels._check_tma_weight("k", w)
        kernels._check_tma_weight("k", w[16:])
        with pytest.raises(ValueError, match="16-byte boundary"):
            kernels._check_tma_weight("k", w[1:])


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs the same checks on the card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_card(cuda_device):
    rng = np.random.default_rng(10)
    x, w, colsum, inv, bias = (torch.as_tensor(a).to(cuda_device) if isinstance(a, np.ndarray)
                               else a for a in _layer(rng, 256, 256, 256))
    lin = torch.as_tensor(rng.uniform(-7, 7, (256, 256)).astype(np.float32)).to(cuda_device)
    assert torch.equal(kernels.bias_sigmoid_i8(lin, bias), tops.bias_sigmoid_i8(lin, bias))
    # K9: B = 320 (a ragged 128-frame block), K = 432 and 429 (padded), H = 384
    for k_in in (432, 429):
        frames, w_in, b_in = (torch.as_tensor(a).to(cuda_device)
                              for a in _input_layer(rng, 320, k_in, 384))
        got = kernels.input_layer(frames, w_in, kernels.input_layer_operand(w_in), b_in)
        _assert_counts_close(got.cpu().numpy(), tops.input_layer_step(frames, w_in, b_in).cpu().numpy())
    # K2: square and not, B = 64 and 192 (clusters of 1), 256 (clusters of 2)
    w_t = kernels.kernel_layout(w)
    for args in ((x, w, colsum, inv, bias),
                 tuple(torch.as_tensor(a).to(cuda_device) if isinstance(a, np.ndarray) else a
                       for a in _layer(rng, 256, 384, 640))):
        xl, wl, cl, il, bl = args
        wl_t = kernels.kernel_layout(wl)
        for b in (64, 192, 256):
            want = tops.hidden_layer_step(xl[:b], wl, cl, float(il), bl)
            assert torch.equal(kernels.hidden_layer(xl[:b], wl_t, cl, float(il), bl), want), (
                tuple(wl.shape), b)
    # K3: B = 128 (a cluster of 2 blocks) and 192 (three blocks: clusters
    # of 1), L = 2, H = 256
    stack = (torch.stack([w, w]), torch.stack([colsum, colsum]),
             torch.tensor([inv, inv], device=cuda_device), torch.stack([bias, bias]))
    w_stack = kernels.kernel_layout(stack[0])
    for b in (128, 192):
        want = tops.hidden_stack_step(x[:b], stack)
        assert torch.equal(kernels.hidden_stack(x[:b], w_stack, *stack[1:]), want), b
    # K4: K = 256, N = 384, out_dim 200; unmasked, masked (both semantics)
    # and bf16; K6 on the same masks
    xo, wo, co, io, bo = (torch.as_tensor(a).to(cuda_device) if isinstance(a, np.ndarray)
                          else a for a in _layer(rng, 192, 256, 384))
    wo_t = kernels.kernel_layout(wo)
    masks = torch.as_tensor((rng.random((192, 384)) < 0.4).astype(np.uint8)).to(cuda_device)
    masks[64:128] = 0  # a frame block with no active tile
    for b in (128, 192):
        want = tops.output_posteriors(xo[:b], wo, co, float(io), bo, out_dim=200)
        got = kernels.resident_softmax(xo[:b], wo_t, co, float(io), bo, out_dim=200)
        assert float((got - want).abs().max()) <= SOFTMAX_ATOL, b
        for semantics in ("reference", "active_only"):
            want_m = tops.output_posteriors(xo[:b], wo, co, float(io), bo, masks[:b], out_dim=200,
                                            semantics=semantics)
            for fn in (kernels.resident_softmax, kernels.resident_softmax_block_sparse):
                got = fn(xo[:b], wo_t, co, float(io), bo, masks[:b], out_dim=200,
                         semantics=semantics)
                assert float((got - want_m).abs().max()) <= SOFTMAX_ATOL, (b, semantics, fn)
        got = kernels.resident_softmax(xo[:b], wo_t, co, float(io), bo, out_dim=200, fast=True)
        assert got.dtype == torch.bfloat16
        assert torch.allclose(got.float(), want, rtol=2e-2, atol=1e-3), b

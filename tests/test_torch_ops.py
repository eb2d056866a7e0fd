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


class TestHiddenLayer:
    @pytest.mark.parametrize("b,k,n", [(256, 256, 256), (64, 384, 128)])
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
        assert {"common.cuh", "hopper.cuh"} <= names
        for src in ("hidden_stack.cu", "resident_softmax.cu"):
            assert '#include "hopper.cuh"' in (_build.CSRC / src).read_text()

    def test_sources_note_what_they_replace(self):
        for k in kernels.KERNELS.values():
            text = (_build.CSRC / k.source.rsplit("/", 1)[1]).read_text()
            assert "Replaces" in text and "fastdnn_tpu/ops/pallas_kernels.py" in text
            assert "Bound:" in text


class TestLoops:
    """The Python side of K3's and K4's two loops: loop names, the weight's
    alignment, and the cluster size a K3 launch gets."""

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
        with pytest.raises(ValueError, match="unknown loop"):
            kernels._check_loop("k", "tiles")

    def test_loop_arguments_on_cpu(self):
        rng = np.random.default_rng(11)
        x, w, colsum, inv, bias = _layer(rng, 64, 128, 128)
        args = (torch.as_tensor(x), kernels.kernel_layout(torch.as_tensor(w)),
                torch.as_tensor(colsum), float(inv), torch.as_tensor(bias))
        with pytest.raises(ValueError, match="unknown loop"):
            kernels.resident_softmax(*args, out_dim=100, loop="tiles")
        stack = (args[1][None], args[2][None], torch.tensor([inv]), args[4][None])
        with pytest.raises(ValueError, match="unknown loop"):
            kernels.hidden_stack(args[0], *stack, loop="tiles")


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
    w_t = kernels.kernel_layout(w)
    assert torch.equal(kernels.hidden_layer(x, w_t, colsum, float(inv), bias),
                       tops.hidden_layer_step(x, w, colsum, float(inv), bias))
    # K3, both loops: B = 128 (a cluster of 2 blocks) and 192 (three blocks:
    # clusters of 1), L = 2, H = 256
    stack = (torch.stack([w, w]), torch.stack([colsum, colsum]),
             torch.tensor([inv, inv], device=cuda_device), torch.stack([bias, bias]))
    w_stack = kernels.kernel_layout(stack[0])
    for b in (128, 192):
        want = tops.hidden_stack_step(x[:b], stack)
        for loop in kernels.LOOPS:
            got = kernels.hidden_stack(x[:b], w_stack, *stack[1:], loop=loop)
            assert torch.equal(got, want), (b, loop)
    # K4: K = 256, N = 384, out_dim 200; on both loops unmasked, masked
    # (both semantics) and bf16
    xo, wo, co, io, bo = (torch.as_tensor(a).to(cuda_device) if isinstance(a, np.ndarray)
                          else a for a in _layer(rng, 192, 256, 384))
    wo_t = kernels.kernel_layout(wo)
    masks = torch.as_tensor((rng.random((192, 384)) < 0.4).astype(np.uint8)).to(cuda_device)
    for b in (128, 192):
        want = tops.output_posteriors(xo[:b], wo, co, float(io), bo, out_dim=200)
        for loop in kernels.LOOPS:
            got = kernels.resident_softmax(xo[:b], wo_t, co, float(io), bo, out_dim=200, loop=loop)
            assert float((got - want).abs().max()) <= SOFTMAX_ATOL, (b, loop)
        for semantics in ("reference", "active_only"):
            want_m = tops.output_posteriors(xo[:b], wo, co, float(io), bo, masks[:b], out_dim=200,
                                            semantics=semantics)
            for loop in kernels.LOOPS:
                got = kernels.resident_softmax(xo[:b], wo_t, co, float(io), bo, masks[:b],
                                               out_dim=200, semantics=semantics, loop=loop)
                assert float((got - want_m).abs().max()) <= SOFTMAX_ATOL, (b, semantics, loop)
        for loop in kernels.LOOPS:
            got = kernels.resident_softmax(xo[:b], wo_t, co, float(io), bo, out_dim=200, fast=True,
                                           loop=loop)
            assert got.dtype == torch.bfloat16
            assert torch.allclose(got.float(), want, rtol=2e-2, atol=1e-3), (b, loop)

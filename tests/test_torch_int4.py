"""The PyTorch port's int4 hidden trunk against the JAX package, on CPU.

Float nets are drawn with numpy in the port and handed to the JAX package
as the same arrays, so both quantize identical weights.  The JAX package
holds int4 values as `ml_dtypes.int4` (and their colsums as int64); the
port holds them as int8 (int32 colsums), so values are compared after a
cast.  Bounds:
  * quantization, packing, unpacking and the packed layer step: bitwise;
  * posteriors from frames: within 1e-4 of the JAX scorer with at least
    99.9% argmax agreement (the float input layer's f32 summation order may
    flip a rare first-layer count, as for the int8 trunk);
  * the float-oracle gate of the JAX package's TestInt4Trunk: the summed
    |posterior difference| per senone over 100 frames stays <= 0.1.
"""

import jax
import numpy as np
import pytest
import torch

import fastdnn_tpu as fd
import fastdnn_tpu_torch as fdt
from fastdnn_tpu.ops import matmul as jops
from fastdnn_tpu.ops import pallas_kernels as jpk
from fastdnn_tpu.quant import serialize as jser
from fastdnn_tpu_torch.engine.backend import KERNELS
from fastdnn_tpu_torch.ops import kernels
from fastdnn_tpu_torch.ops import matmul as tops
from fastdnn_tpu_torch.quant.serialize import qnet_arrays

POSTERIOR_ATOL = 1e-4
ARGMAX_AGREEMENT = 0.999
ORACLE_GATE = 0.1


def _nets(seed, hidden, out=400, input_dim=432):
    t_net = fdt.random_net(np.random.default_rng(seed), input_dim, list(hidden), out)
    return t_net, fd.from_raw(fdt.to_raw(t_net))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_qnets_equal(t_q, j_q):
    for field in ("weights", "colsum128", "inv_scales", "multipliers", "biases"):
        for a, b in zip(getattr(t_q, field), getattr(j_q, field), strict=True):
            a, b = _np(a), np.asarray(b)
            if b.dtype.kind == "f":
                assert b.dtype == a.dtype, field
            else:
                b = b.astype(a.dtype)  # int4 -> int8, int64 colsums -> int32: exact
            assert a.shape == b.shape and a.tobytes() == b.tobytes(), field


def _frames(seed, n):
    return np.random.default_rng(seed).standard_normal((n, 432), dtype=np.float32)


def _acts(seed, b, k):
    return np.random.default_rng(seed).integers(-128, 128, (b, k)).astype(np.int8)


# (port int4 net, JAX int4 net) for the 256- and the 384-wide trunk
@pytest.fixture(scope="module", params=[(256, 256, 256), (384, 384)], ids=["3x256", "2x384"])
def q4(request):
    t_net, j_net = _nets(sum(request.param), request.param)
    return fdt.quantize_net(t_net, hidden_bits=4), fd.quantize_net(j_net, hidden_bits=4)


class TestQuantizeAndPack:
    @pytest.mark.parametrize("cutoff", [3.0, 0.05, 1e6])
    def test_quantize_net_bitwise(self, cutoff):
        t_net, j_net = _nets(21, (256, 384))
        t_q = fdt.quantize_net(t_net, cutoff=cutoff, hidden_bits=4)
        j_q = fd.quantize_net(j_net, cutoff=cutoff, hidden_bits=4)
        _assert_qnets_equal(t_q, j_q)
        assert t_q.hidden_bits == 4 and t_q.layer_dims() == j_q.layer_dims()

    def test_quantize_layer_edge_cases_bitwise(self):
        for arr in (
            np.zeros((8, 8), np.float32),
            np.full((4, 4), 1e-4, np.float32),
            np.linspace(-9, 9, 64, dtype=np.float32).reshape(8, 8),
            np.random.default_rng(22).standard_normal((64, 48), dtype=np.float32) * 0.3,
        ):
            tq, tm = fdt.quantize_layer(torch.as_tensor(arr), 3.0, bits=4)
            jq, jm = fd.quantize_layer(arr, 3.0, bits=4)
            assert tq.dtype == torch.int8
            np.testing.assert_array_equal(tq.numpy(), np.asarray(jq).astype(np.int8))
            assert tm.dtype == torch.float32 and tm.numpy().tobytes() == np.float32(jm).tobytes()
        with pytest.raises(ValueError, match="bits"):
            fdt.quantize_layer(torch.zeros(2, 2), 3.0, bits=2)

    def test_pack_and_unpack_bitwise(self, q4):
        t_q, j_q = q4
        t_p, j_p = fdt.pack_int4_trunk(t_q), fd.pack_int4_trunk(j_q)
        assert t_p.packed_int4 and j_p.packed_int4 and t_p.hidden_bits == 4
        _assert_qnets_equal(t_p, j_p)
        for wp, w in zip(t_p.weights[:-1], t_q.weights[:-1], strict=True):
            assert wp.shape == (w.shape[0] // 2, w.shape[1])
            lo, hi = tops.unpack_int4_pair(wp)
            jlo, jhi = jops.unpack_int4_pair(np.asarray(wp.numpy()))
            np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
            np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
            np.testing.assert_array_equal(torch.cat([lo, hi]).numpy(), w.numpy())
        assert t_p.weights[-1] is t_q.weights[-1]
        assert fdt.pack_int4_trunk(t_p) is t_p  # idempotent

    def test_pack_passes_int8_nets_and_refuses_odd_k(self):
        t_net, _ = _nets(24, (64, 64), out=40, input_dim=32)
        q8 = fdt.quantize_net(t_net)
        assert fdt.pack_int4_trunk(q8) is q8
        odd, _ = _nets(25, (63, 64), out=40, input_dim=32)
        with pytest.raises(ValueError, match="even K"):
            fdt.pack_int4_trunk(fdt.quantize_net(odd, hidden_bits=4))

    def test_every_nibble_pair_round_trips(self):
        v = torch.arange(-8, 8, dtype=torch.int8)
        lo, hi = torch.meshgrid(v, v, indexing="ij")
        w = torch.cat([lo.reshape(-1, 1), hi.reshape(-1, 1)])  # K = 512, N = 1
        q = fdt.QuantizedNet(
            torch.zeros(1, 512), torch.zeros(512), (w, torch.zeros(1, 1, dtype=torch.int8)),
            (torch.zeros(1, dtype=torch.int32),) * 2, (torch.zeros(1),) * 2,
            (torch.tensor(1.0),) * 2, (torch.tensor(1.0),) * 2, hidden_bits=4,
        )
        packed = fdt.pack_int4_trunk(q).weights[0]
        assert torch.equal(torch.cat(tops.unpack_int4_pair(packed)), w)


class TestPackedLayerStep:
    def test_step_bitwise_with_jax_pallas_and_unpacked(self, q4):
        t_q, j_q = q4
        t_p, j_p = fdt.pack_int4_trunk(t_q), fd.pack_int4_trunk(j_q)
        k = t_q.weights[0].shape[0]
        acts = _acts(k, 128, k)
        args_t = (t_p.weights[0], t_p.colsum128[0], t_p.inv_scales[0], t_p.biases[0])
        got = tops.hidden_layer_step_packed(torch.as_tensor(acts), *args_t).numpy()
        j_args = (j_p.weights[0], j_p.colsum128[0], j_p.inv_scales[0], j_p.biases[0])
        want = np.asarray(jax.jit(jops.hidden_layer_step_packed)(acts, *j_args))
        pallas = np.asarray(jpk.fused_hidden_layer(acts, *j_args[:2], j_args[2], j_args[3],
                                                   packed=True, interpret=True))
        unpacked = tops.hidden_layer_step(
            torch.as_tensor(acts), t_q.weights[0], t_q.colsum128[0], t_q.inv_scales[0],
            t_q.biases[0],
        ).numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, pallas)
        np.testing.assert_array_equal(got, unpacked)

    @pytest.mark.parametrize("k,n", [(384, 384), (128, 128), (128, 256)])
    def test_wrapper_at_narrow_k_matches_pallas_packed(self, k, n):
        """K7's edge widths: K/2 = 192 and 64 are not multiples of the
        kernel's 128-byte packed stage.  The wrapper on CPU tensors against
        the Pallas packed kernel in interpret mode, and against K2's plain
        version on the same int4 values held unpacked."""
        rng = np.random.default_rng(k + n)
        w = rng.integers(-8, 8, (k, n), dtype=np.int8)
        packed = ((w[: k // 2] & 0xF) | (w[k // 2:] << 4)).astype(np.int8)
        colsum = 128 * w.astype(np.int32).sum(axis=0, dtype=np.int32)
        inv = np.float32(1.0 / (rng.integers(5, 20) * 255.0))
        bias = (rng.standard_normal(n) * 0.5).astype(np.float32)
        acts = _acts(k * n, 128, k)
        want = np.asarray(jpk.fused_hidden_layer(acts, packed, colsum, inv, bias, packed=True,
                                                 interpret=True))
        t = [torch.as_tensor(a) for a in (acts, packed, colsum, bias, w)]
        got = kernels.hidden_layer_packed(t[0], kernels.kernel_layout(t[1]), t[2], float(inv), t[3])
        unpacked = kernels.hidden_layer(t[0], kernels.kernel_layout(t[4]), t[2], float(inv), t[3])
        assert got.shape == (128, n) and got.dtype == torch.int8
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(got.numpy(), unpacked.numpy())

    def test_kernel_wrapper_on_cpu_takes_the_kernel_layout(self, q4):
        t_q, _ = q4
        t_p = fdt.pack_int4_trunk(t_q)
        k = t_q.weights[0].shape[0]
        acts = torch.as_tensor(_acts(7, 64, k))
        args = (t_p.colsum128[0], t_p.inv_scales[0], t_p.biases[0])
        got = kernels.hidden_layer_packed(acts, kernels.kernel_layout(t_p.weights[0]), *args)
        assert torch.equal(got, tops.hidden_layer_step_packed(acts, t_p.weights[0], *args))


class TestScorer:
    @pytest.mark.parametrize("packed", [False, True], ids=["unpacked", "packed"])
    @pytest.mark.parametrize("backend_kw", [
        dict(backend="xla"),
        dict(backend="pallas", interpret=True),
    ], ids=["xla", "pallas-interpret"])
    def test_scorer_from_frames_matches_jax(self, q4, packed, backend_kw):
        t_q, j_q = q4
        frames = _frames(31, 300)
        want = fd.Scorer(j_q, fd.EngineConfig(int4_packed=packed, **backend_kw)).score(frames)
        scorer = fdt.Scorer(t_q, fdt.EngineConfig(int4_packed=packed), device="cpu")
        assert scorer.net.packed_int4 == packed and scorer.net.hidden_bits == 4
        got = scorer.score(frames)
        assert got.shape == want.shape and got.dtype == np.float32 and np.isfinite(got).all()
        assert np.abs(got - want).max() <= POSTERIOR_ATOL
        assert (got.argmax(1) == want.argmax(1)).mean() >= ARGMAX_AGREEMENT
        np.testing.assert_allclose(got.sum(axis=1), 1.0, rtol=0, atol=1e-5)

    def test_packed_hidden_activations_bitwise(self, q4):
        t_q, j_q = q4
        frames = _frames(32, 256)
        pallas = fd.Scorer(j_q, fd.EngineConfig(backend="pallas", interpret=True, int4_packed=True))
        jf, _ = pallas._prepare(frames)
        j_acts = np.asarray(pallas._hidden(pallas.net, jf))
        # from the JAX first layer, so the two float input layers cannot differ
        acts0 = torch.as_tensor(np.array(jax.jit(jops.input_layer_step)(
            frames, j_q.input_w, j_q.input_b)))
        t_p = fdt.pack_int4_trunk(t_q)
        packed, unpacked = acts0, acts0
        for i in range(len(t_q.weights) - 1):
            packed = tops.hidden_layer_step_packed(
                packed, t_p.weights[i], t_p.colsum128[i], t_p.inv_scales[i], t_p.biases[i])
            unpacked = tops.hidden_layer_step(
                unpacked, t_q.weights[i], t_q.colsum128[i], t_q.inv_scales[i], t_q.biases[i])
        np.testing.assert_array_equal(packed.numpy(), unpacked.numpy())
        np.testing.assert_array_equal(packed.numpy(), j_acts[:, : packed.shape[1]])

    def test_packed_and_unpacked_scorers_equal(self, q4):
        t_q, _ = q4
        frames = _frames(33, 200)
        masks = (np.random.default_rng(33).random((200, 400)) < 0.4).astype(np.uint8)
        plain = fdt.Scorer(t_q, device="cpu")
        packed = fdt.Scorer(t_q, fdt.EngineConfig(int4_packed=True), device="cpu")
        assert packed._hstack is None and fdt.build_hidden_stack(packed.net) is None
        np.testing.assert_array_equal(packed.score(frames), plain.score(frames))
        np.testing.assert_array_equal(packed.score_masked(frames, masks),
                                      plain.score_masked(frames, masks))
        ctx_p, ctx_u = packed.new_lazy_context(4), plain.new_lazy_context(4)
        ctx_p.calculate_until_output(frames[:4])
        ctx_u.calculate_until_output(frames[:4])
        np.testing.assert_array_equal(ctx_p.calculate_for_output_nodes(masks[0]),
                                      ctx_u.calculate_for_output_nodes(masks[0]))

    @pytest.mark.parametrize("hidden", [(200, 200, 200), (300, 300), (96, 160)],
                             ids=["3x200", "2x300", "unequal"])
    def test_cuda_layout_pad_then_pack_on_cpu(self, hidden):
        """The CUDA Scorer's preparation (pad to 128, pack, transpose to the
        kernels' [N, K/2]), run through the kernel wrappers on CPU tensors
        (their plain versions), equals the plain scorer.  300 pads to 384,
        whose packed half (192) is not a multiple of 128."""
        t_net, _ = _nets(sum(hidden), hidden)
        q = fdt.quantize_net(t_net, hidden_bits=4)
        frames = torch.as_tensor(_frames(34, 128))
        want = fdt.score_fn(q, frames, backend="torch")
        padded = fdt.pad_qnet(q, lanes=kernels.TILE_N, out_lanes=kernels.TILE_N)
        packed = KERNELS.prepare(q, "cpu", int4_packed=True)
        assert packed.packed_int4 and packed.hidden_bits == 4
        for w, wq in zip(packed.weights[:-1], padded.weights[:-1]):
            assert w.shape == (wq.shape[1], wq.shape[0] // 2)
        got = fdt.score_fn(packed, frames, backend="cuda", fused_softmax=True, out_dim=q.output_dim)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)
        unpacked = KERNELS.prepare(q, "cpu")
        stacked = fdt.score_fn(unpacked, frames, backend="cuda", fused_softmax=True,
                               out_dim=q.output_dim, hstack=fdt.build_hidden_stack(unpacked),
                               stack_max_frames=8192)
        np.testing.assert_array_equal(stacked.numpy(), got.numpy())

    def test_float_oracle_gate(self):
        t_net, j_net = _nets(35, (256, 256, 256))
        frames = _frames(35, 100)
        oracle = np.asarray(fd.forward(j_net, frames))
        np.testing.assert_allclose(fdt.forward(t_net, torch.as_tensor(frames)).numpy(), oracle,
                                   rtol=0, atol=1e-6)
        for packed in (False, True):
            scorer = fdt.Scorer(fdt.quantize_net(t_net, hidden_bits=4),
                                fdt.EngineConfig(int4_packed=packed), device="cpu")
            summed = np.abs(scorer.score(frames) - oracle).sum(axis=0)
            assert summed.max() <= ORACLE_GATE, f"int4 trunk fails the oracle gate: {summed.max()}"


class TestCheckpointsAndGuards:
    def test_port_int4_checkpoint_loads_in_jax(self, q4, tmp_path):
        t_q, j_q = q4
        fdt.save_qnet(t_q, tmp_path / "q4.npz")
        j_back = fd.load_qnet(tmp_path / "q4.npz")
        assert all(str(w.dtype) == "int4" for w in j_back.weights[:-1])
        assert j_back.weights[-1].dtype == np.int8
        for a, b in zip(j_back.weights, j_q.weights, strict=True):
            np.testing.assert_array_equal(np.asarray(a).astype(np.int8), np.asarray(b).astype(np.int8))
        _, banner = jser.load_quantized(str(tmp_path / "q4.npz"))
        assert "int4-trunk" in banner
        t_back = fdt.load_qnet(tmp_path / "q4.npz")
        assert t_back.hidden_bits == 4
        _assert_qnets_equal(t_back, j_q)

    def test_flags_survive_every_step(self, q4, tmp_path):
        t_q, _ = q4
        padded = fdt.pad_qnet(t_q)
        assert padded.hidden_bits == 4 and not padded.packed_int4
        packed = fdt.pack_int4_trunk(padded)
        for net in (packed.to("cpu"), KERNELS.prepare(padded, "cpu", int4_packed=True)):
            assert net.hidden_bits == 4 and net.packed_int4
        fdt.save_qnet(padded, tmp_path / "p.npz")
        back = fdt.load_qnet(tmp_path / "p.npz")
        assert back.hidden_bits == 4 and back.true_output_dim == t_q.output_dim

    def test_bits_mismatch_refused_by_both_packages(self, q4, tmp_path):
        """An int8 checkpoint asked for as int4 is refused, and the JAX
        package refuses both mismatches as the port does (the port's int4
        checkpoint asked for as int8: test_torch_model_quant.py)."""
        t_q, _ = q4
        fdt.save_qnet(t_q, tmp_path / "q4.npz")
        fdt.save_qnet(fdt.quantize_net(_nets(36, (64, 64))[0]), tmp_path / "q8.npz")
        with pytest.raises(ValueError, match="hidden_bits=4 requested"):
            fdt.load_quantized(tmp_path / "q8.npz", hidden_bits=4)
        # the JAX package refuses the same mismatches
        with pytest.raises(ValueError, match="hidden_bits=8 requested"):
            jser.load_quantized(str(tmp_path / "q4.npz"), hidden_bits=8)
        with pytest.raises(ValueError, match="hidden_bits=4 requested"):
            jser.load_quantized(str(tmp_path / "q8.npz"), hidden_bits=4)

    def test_mixed_bits_markers_refused(self, q4, tmp_path):
        t_q, _ = q4
        arrays = qnet_arrays(t_q)
        arrays[f"bits_{len(t_q.weights) - 1}"] = np.int32(4)  # an int4 output layer
        with pytest.raises(ValueError, match="bits markers"):
            fdt.qnet_from_arrays(arrays)
        if len(t_q.weights) > 2:
            arrays = qnet_arrays(t_q)
            arrays["bits_0"] = np.int32(8)  # one int8 layer in an int4 trunk
            with pytest.raises(ValueError, match="bits markers"):
                fdt.qnet_from_arrays(arrays)

    def test_float_model_quantized_on_load_with_hidden_bits(self, tmp_path):
        t_net, j_net = _nets(37, (256, 256))
        fdt.write_model(fdt.to_raw(t_net), tmp_path / "m.bin")
        t_q, banner = fdt.load_quantized(tmp_path / "m.bin", hidden_bits=4)
        j_q, _ = jser.load_quantized(str(tmp_path / "m.bin"), hidden_bits=4)
        assert banner == "432-1x256-400" and t_q.hidden_bits == 4
        _assert_qnets_equal(t_q, j_q)
        assert fdt.load_quantized(tmp_path / "m.bin")[0].hidden_bits == 8


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs the same checks on the card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("b, k, n", [(8320, 2048, 2048), (128, 384, 384), (192, 384, 2048)])
def test_k7_bitwise_with_plain_and_k2_on_card(cuda_device, b, k, n):
    rng = np.random.default_rng(k + n)
    w = torch.from_numpy(rng.integers(-8, 8, (k, n)).astype(np.int8))
    lo, hi = w[: k // 2].int(), w[k // 2:].int()
    packed = (hi * 16 + (lo & 0xF)).to(torch.int8)
    acts = torch.from_numpy(rng.integers(-128, 128, (b, k)).astype(np.int8)).to(cuda_device)
    colsum = (128 * w.int().sum(0, dtype=torch.int32)).to(cuda_device)
    bias = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(cuda_device)
    inv_scale = float(np.float32(1 / (3 * 255)))
    k7 = kernels.hidden_layer_packed(acts, kernels.kernel_layout(packed).to(cuda_device), colsum,
                                     inv_scale, bias)
    plain = tops.hidden_layer_step_packed(acts, packed.to(cuda_device), colsum, inv_scale, bias)
    k2 = kernels.hidden_layer(acts, kernels.kernel_layout(w).to(cuda_device), colsum, inv_scale,
                              bias)
    torch.cuda.synchronize()
    assert torch.equal(k7, plain) and torch.equal(k7, k2)

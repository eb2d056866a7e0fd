"""Parity of the PyTorch port's model, quantization and file-format modules
with the JAX package, on CPU.

Float nets are drawn once with numpy in the port and handed to the JAX
package as the same arrays (its `from_raw` reads any RawNetwork-shaped
object), so both packages quantize identical float weights.
"""

import os

import numpy as np
import pytest
import torch

import fastdnn_tpu as fd
import fastdnn_tpu_torch as fdt
from fastdnn_tpu.formats import binary as jbin
from fastdnn_tpu_torch.formats import binary as tbin

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def _nets(seed, hidden=(256, 256, 256), out=400, input_dim=432):
    t_net = fdt.random_net(np.random.default_rng(seed), input_dim, list(hidden), out)
    return t_net, fd.from_raw(fdt.to_raw(t_net))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_fields_equal(t_q, j_q, fields=("weights", "colsum128", "inv_scales", "multipliers")):
    for field in fields:
        for a, b in zip(getattr(t_q, field), getattr(j_q, field), strict=True):
            assert _np(a).dtype == _np(b).dtype, field
            np.testing.assert_array_equal(_np(a), _np(b), err_msg=field)


class TestModel:
    def test_from_raw_to_raw_round_trip(self):
        t_net, j_net = _nets(1)
        back = fdt.to_raw(fdt.from_raw(fd.to_raw(j_net)))
        for a, b in zip(back.layers, fdt.to_raw(t_net).layers, strict=True):
            np.testing.assert_array_equal(a.weights, b.weights)
            np.testing.assert_array_equal(a.bias, b.bias)

    def test_align_matches_jax(self):
        t_net, j_net = _nets(2, hidden=(250, 250), out=90, input_dim=429)
        ta, ja = fdt.align(t_net, 4, 16), fd.align(j_net, 4, 16)
        assert ta.layer_dims() == ja.layer_dims() == [256, 256, 90]
        assert ta.input_dim == ja.input_dim == 432
        for a, b in zip(ta.weights + ta.biases, ja.weights + ja.biases, strict=True):
            np.testing.assert_array_equal(_np(a), _np(b))
        np.testing.assert_array_equal(_np(ta.scale), _np(ja.scale))

    def test_forward_matches_jax_oracle(self):
        t_net, j_net = _nets(3)
        frames = np.random.default_rng(3).standard_normal((64, 432), dtype=np.float32)
        ours = fdt.forward(t_net, torch.as_tensor(frames)).numpy()
        theirs = np.asarray(fd.forward(j_net, frames))
        np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-6)

    def test_fuse_transform_matches_jax(self):
        t_net, j_net = _nets(4)
        tf, jf = fdt.fuse_transform(t_net), fd.fuse_transform(j_net)
        np.testing.assert_array_equal(_np(tf.weights[0]), _np(jf.weights[0]))
        # the fused bias is a dot product: summation order may move the last bit
        np.testing.assert_allclose(_np(tf.biases[0]), _np(jf.biases[0]), rtol=1e-6, atol=1e-6)


class TestQuantize:
    @pytest.mark.parametrize("cutoff", [3.0, 0.05])
    def test_quantize_net_matches_jax_exactly(self, cutoff):
        t_net, j_net = _nets(5)
        t_q = fdt.quantize_net(t_net, cutoff=cutoff)
        j_q = fd.quantize_net(j_net, cutoff=cutoff)
        _assert_fields_equal(t_q, j_q, ("weights", "colsum128", "inv_scales", "multipliers", "biases"))
        np.testing.assert_array_equal(_np(t_q.input_w), _np(j_q.input_w))
        assert t_q.output_dim == j_q.output_dim and t_q.layer_dims() == j_q.layer_dims()

    def test_quantize_layer_edge_cases_match_jax(self):
        w = np.zeros((8, 8), np.float32)
        for arr in (w, np.full((4, 4), 1e-4, np.float32), np.linspace(-9, 9, 64, dtype=np.float32).reshape(8, 8)):
            tq, tm = fdt.quantize_layer(torch.as_tensor(arr), 3.0)
            jq, jm = fd.quantize_layer(arr, 3.0)
            np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
            assert float(tm) == float(jm)

    def test_int4_quantize_net_matches_jax_exactly(self):
        t_net, j_net = _nets(6)
        t_q = fdt.quantize_net(t_net, hidden_bits=4)
        j_q = fd.quantize_net(j_net, hidden_bits=4)
        assert t_q.hidden_bits == 4 and not t_q.packed_int4
        # JAX holds the int4 trunk as ml_dtypes.int4 and its colsums as int64
        for field in ("weights", "colsum128", "inv_scales", "multipliers", "biases"):
            for a, b in zip(getattr(t_q, field), getattr(j_q, field), strict=True):
                np.testing.assert_array_equal(_np(a), _np(b).astype(_np(a).dtype), err_msg=field)
                assert _np(a).tobytes() == _np(b).astype(_np(a).dtype).tobytes(), field
        assert t_q.weights[-1].dtype == torch.int8 and int(t_q.weights[-1].abs().max()) > 8
        for w in t_q.weights[:-1]:
            assert w.dtype == torch.int8 and -8 <= int(w.min()) and int(w.max()) <= 7

    def test_int4_is_refused(self):
        """What stays refused for int4: other bit widths, and padding a
        packed trunk (pad first, then pack)."""
        t_net, _ = _nets(6)
        with pytest.raises(ValueError, match="hidden_bits must be 8 or 4"):
            fdt.quantize_net(t_net, hidden_bits=2)
        packed = fdt.pack_int4_trunk(fdt.quantize_net(t_net, hidden_bits=4))
        with pytest.raises(ValueError, match="pad before packing"):
            fdt.pad_qnet(packed)

    def test_pad_qnet_matches_pad_qnet_for_tpu(self):
        t_net, j_net = _nets(7, hidden=(200, 200, 200), out=1000)
        t_p = fdt.pad_qnet(fdt.quantize_net(t_net), lanes=128, out_lanes=1024)
        j_p = fd.pad_qnet_for_tpu(fd.quantize_net(j_net), lanes=128, out_lanes=1024)
        _assert_fields_equal(t_p, j_p, ("weights", "colsum128", "inv_scales", "multipliers", "biases"))
        np.testing.assert_array_equal(_np(t_p.input_w), _np(j_p.input_w))
        assert t_p.output_dim == j_p.output_dim == 1000
        assert t_p.padded_output_dim == j_p.padded_output_dim == 1024

    def test_padding_changes_no_posterior(self):
        t_net, _ = _nets(8, hidden=(200, 200, 200), out=1000)
        q = fdt.quantize_net(t_net)
        frames = torch.as_tensor(np.random.default_rng(8).standard_normal((96, 432), dtype=np.float32))
        plain = fdt.score_fn(q, frames, backend="torch")
        padded_q = fdt.pad_qnet(q)
        assert padded_q.layer_dims() == [256, 256, 256, 1024]
        padded = fdt.score_fn(padded_q, frames, backend="torch")
        assert padded.shape == plain.shape == (96, 1000)
        np.testing.assert_array_equal(
            fdt.hidden_forward(padded_q, frames, "torch")[:, :200].numpy(),
            fdt.hidden_forward(q, frames, "torch").numpy(),
        )
        np.testing.assert_allclose(padded.numpy(), plain.numpy(), rtol=0, atol=1e-7)


class TestFormats:
    def test_read_model_golden_equal_in_both_packages(self):
        path = f"{GOLDEN}/parity_model.bin"
        ours, theirs = tbin.read_model(path), jbin.read_model(path)
        assert ours.topology() == theirs.topology()
        for a, b in zip(ours.layers, theirs.layers, strict=True):
            np.testing.assert_array_equal(a.weights, b.weights)
            np.testing.assert_array_equal(a.bias, b.bias)
        np.testing.assert_array_equal(ours.shift, theirs.shift)
        np.testing.assert_array_equal(ours.scale, theirs.scale)

    @pytest.mark.parametrize("little_endian", [False, True])
    def test_write_model_bytes_equal_jax(self, tmp_path, little_endian):
        raw = tbin.read_model(f"{GOLDEN}/divergence_model.bin")
        tbin.write_model(raw, tmp_path / "t.bin", little_endian=little_endian)
        jbin.write_model(raw, tmp_path / "j.bin", little_endian=little_endian)
        assert (tmp_path / "t.bin").read_bytes() == (tmp_path / "j.bin").read_bytes()
        back = tbin.read_model(tmp_path / "t.bin", little_endian=little_endian)
        np.testing.assert_array_equal(back.layers[0].weights, raw.layers[0].weights)

    def test_features_cross_read(self, tmp_path):
        data = np.random.default_rng(9).standard_normal((37, 432), dtype=np.float32)
        jbin.write_features(data, tmp_path / "j.bin")
        np.testing.assert_array_equal(tbin.read_features(tmp_path / "j.bin"), data)
        tbin.write_features(data, tmp_path / "t.bin", max_frames=20)
        np.testing.assert_array_equal(jbin.read_features(tmp_path / "t.bin"), data[:20])

    def test_truncated_files_raise(self, tmp_path):
        (tmp_path / "m.bin").write_bytes(open(f"{GOLDEN}/parity_model.bin", "rb").read()[:1000])
        with pytest.raises(ValueError, match="truncated"):
            tbin.read_model(tmp_path / "m.bin")
        (tmp_path / "f.bin").write_bytes(np.array([5, 4], ">i4").tobytes())
        with pytest.raises(ValueError, match="truncated"):
            tbin.read_features(tmp_path / "f.bin")


class TestCheckpoints:
    def test_jax_checkpoint_loads_in_port(self, tmp_path):
        _, j_net = _nets(10)
        j_q = fd.pad_qnet_for_tpu(fd.quantize_net(j_net))
        fd.save_qnet(j_q, tmp_path / "q.npz")
        t_q = fdt.load_qnet(tmp_path / "q.npz")
        _assert_fields_equal(t_q, j_q, ("weights", "colsum128", "inv_scales", "multipliers", "biases"))
        np.testing.assert_array_equal(_np(t_q.input_b), _np(j_q.input_b))
        assert t_q.true_output_dim == j_q.true_output_dim == 400
        with np.load(tmp_path / "q.npz") as z:
            arrays = {k: np.asarray(z[k]) for k in z.files}
        _assert_fields_equal(fdt.qnet_from_arrays(arrays), j_q)

    def test_port_checkpoint_loads_in_jax(self, tmp_path):
        t_net, _ = _nets(11)
        t_q = fdt.quantize_net(t_net)
        fdt.save_qnet(t_q, tmp_path / "q.npz")
        j_q = fd.load_qnet(tmp_path / "q.npz")
        _assert_fields_equal(t_q, j_q, ("weights", "colsum128", "inv_scales", "multipliers", "biases"))
        assert j_q.true_output_dim is None
        q2, banner = fdt.load_quantized(tmp_path / "q.npz")
        assert banner == "432-256-256-256-400 (int8 checkpoint)"
        _assert_fields_equal(q2, t_q)

    def test_int4_checkpoint_loads_in_port(self, tmp_path):
        _, j_net = _nets(12)
        j_q = fd.quantize_net(j_net, hidden_bits=4)
        fd.save_qnet(j_q, tmp_path / "q4.npz")
        t_q = fdt.load_qnet(tmp_path / "q4.npz")
        assert t_q.hidden_bits == 4 and not t_q.packed_int4
        for field in ("weights", "colsum128", "inv_scales", "multipliers", "biases"):
            for a, b in zip(getattr(t_q, field), getattr(j_q, field), strict=True):
                np.testing.assert_array_equal(_np(a), _np(b).astype(_np(a).dtype), err_msg=field)
        q2, banner = fdt.load_quantized(tmp_path / "q4.npz")
        assert banner == "432-256-256-256-400 (int4-trunk checkpoint)" and q2.hidden_bits == 4

    def test_int4_checkpoint_is_refused(self, tmp_path):
        """What stays refused for int4 checkpoints: loading one as int8, and
        saving a packed net (its bytes would load with the wrong meaning)."""
        _, j_net = _nets(12)
        fd.save_qnet(fd.quantize_net(j_net, hidden_bits=4), tmp_path / "q4.npz")
        with pytest.raises(ValueError, match="hidden_bits=8 requested"):
            fdt.load_quantized(tmp_path / "q4.npz", hidden_bits=8)
        packed = fdt.pack_int4_trunk(fdt.load_qnet(tmp_path / "q4.npz"))
        with pytest.raises(ValueError, match="unpacked net"):
            fdt.save_qnet(packed, tmp_path / "packed.npz")
        assert not (tmp_path / "packed.npz").exists()

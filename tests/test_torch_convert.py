"""The PyTorch port's front door against the JAX package, on CPU: the Kaldi
nnet1 text parsers, `extend`, the convert CLI's three subcommands and the
score CLI's --text-input and --hidden-bits options.

Text parsing and the binary files are held to equality: the same arrays
bit for bit and byte-identical model and feature files.  Checkpoints hold
the same arrays (the JAX package writes int4 colsums as int64, the port as
int32), except the input bias with the feature transform fused in, a dot
product whose f32 summation order differs (within 1e-6, as in
test_torch_model_quant).  Posteriors from the two CLIs agree within 1e-4
with at least 99.9% argmax agreement, the bound of the scorer tests.
"""

import io
import os
import subprocess
import sys

import numpy as np
import pytest

import fastdnn_tpu as fd
import fastdnn_tpu_torch as fdt
from fastdnn_tpu.cli import convert as jconvert
from fastdnn_tpu.cli import score as jscore
from fastdnn_tpu.formats import kaldi_text as jkt
from fastdnn_tpu_torch.cli import convert as tconvert
from fastdnn_tpu_torch.cli import score as tscore
from fastdnn_tpu_torch.formats import kaldi_text as tkt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POSTERIOR_ATOL = 1e-4
ARGMAX_AGREEMENT = 0.999


def network_text(raw) -> str:
    """A RawNetwork as nnet1 text, with the markers the parser skips."""
    out = ["<Nnet>"]
    for i, layer in enumerate(raw.layers):
        out.append(f"<AffineTransform> {layer.output_dim} {layer.input_dim}")
        out.append("<LearnRateCoef> 1 <BiasLearnRateCoef> 1")
        rows = [" ".join(repr(float(v)) for v in row) for row in layer.weights]
        out.append("[ " + rows[0])
        out.extend("  " + r for r in rows[1:-1])
        out.append("  " + rows[-1] + " ]" if len(rows) > 1 else "]")
        out.append("[ " + " ".join(repr(float(v)) for v in layer.bias) + " ]")
        out.append("<Softmax> {0} {0}".format(layer.output_dim) if i == len(raw.layers) - 1
                   else "<Sigmoid> {0} {0}".format(layer.output_dim))
    out.append("</Nnet>")
    return "\n".join(out) + "\n"


def transform_text(raw, splice=True) -> str:
    blocks = []
    if splice:
        blocks.append("<Splice> 432 432\n[ -5 -4 -3 -2 -1 0 1 2 3 4 5 ]")
    blocks.append("<AddShift> {0} {0}\n<LearnRateCoef> 0 [ {1} ]".format(
        raw.input_dim, " ".join(f"{v:.7g}" for v in raw.shift)))
    blocks.append("<Rescale> {0} {0}\n<LearnRateCoef> 0 [ {1} ]".format(
        raw.input_dim, " ".join(f"{v:.7g}" for v in raw.scale)))
    return "<Nnet>\n" + "\n".join(blocks) + "\n</Nnet>\n"


def _raw(seed, hidden=(64, 64), out=50, input_dim=432):
    return fdt.to_raw(fdt.random_net(np.random.default_rng(seed), input_dim, list(hidden), out))


@pytest.fixture()
def text_model(tmp_path):
    raw = _raw(41)
    (tmp_path / "nnet.txt").write_text(network_text(raw))
    (tmp_path / "tf.txt").write_text(transform_text(raw))
    return tmp_path / "nnet.txt", tmp_path / "tf.txt"


def _assert_raw_equal(a, b):
    assert len(a.layers) == len(b.layers)
    for x, y in zip(a.layers, b.layers):
        assert x.weights.dtype == y.weights.dtype == np.float32
        assert x.weights.tobytes() == y.weights.tobytes()
        assert x.bias.tobytes() == y.bias.tobytes()
    assert a.shift.tobytes() == b.shift.tobytes() and a.scale.tobytes() == b.scale.tobytes()


class TestKaldiText:
    def test_network_parse_equals_jax(self, text_model):
        text = text_model[0].read_text()
        got, want = tkt.parse_network_text(text), jkt.parse_network_text(text)
        assert len(got) == len(want) == 3
        for a, b in zip(got, want):
            assert a.weights.tobytes() == b.weights.tobytes() and a.bias.tobytes() == b.bias.tobytes()

    def test_load_network_text_equals_jax_and_the_drawn_net(self, text_model):
        got = tkt.load_network_text(*text_model)
        _assert_raw_equal(got, jkt.load_network_text(*text_model))
        drawn = _raw(41)
        for a, b in zip(got.layers, drawn.layers):  # repr() round-trips an f32
            np.testing.assert_array_equal(a.weights, b.weights)
        assert fdt.load_model_text(*text_model).layer_dims() == [64, 64, 50]

    @pytest.mark.parametrize("text", [
        "<AffineTransform> 2 3\n[ 1 2 3\n 4 5 ]\n[ 0 0 ]\n",      # short weight row
        "<AffineTransform> 2 3\n[ 1 2 3\n 4 5 6 ]\n[ 0 0 0 ]\n",  # long bias row
        "<AffineTransform> 2 3\n[ 1 2 3\n 4 5 6 ]\n",              # truncated
    ], ids=["short-row", "long-bias", "truncated"])
    def test_network_rejections_match_jax(self, text):
        with pytest.raises(ValueError):
            jkt.parse_network_text(text)
        with pytest.raises(ValueError):
            tkt.parse_network_text(text)

    @pytest.mark.parametrize("text", [
        "<Splice> [ 0 1 2 ] <AddShift> [ 1.5 2.5 ] <Rescale> [ 3.0 4.0 ]",
        "[ 1 2 ] [ 3 4 ]",
        "[ 1 2\n 3 ]\n[ 0.1 0.2 0.3 ]",
    ], ids=["splice", "two-blocks", "multiline"])
    def test_transform_parse_equals_jax(self, text):
        for a, b in zip(tkt.parse_transform_text(text), jkt.parse_transform_text(text)):
            assert a.dtype == b.dtype == np.float32 and a.tobytes() == b.tobytes()

    def test_transform_rejections(self, tmp_path, text_model):
        with pytest.raises(ValueError, match="expected 2 transform blocks"):
            tkt.parse_transform_text("[ 1 2 ]")
        (tmp_path / "short.txt").write_text("[ 1 2 ] [ 3 4 ]")
        with pytest.raises(ValueError, match="shift vector size 2"):
            tkt.load_network_text(text_model[0], tmp_path / "short.txt")

    @pytest.mark.parametrize("text", [
        "utt-a  [\n  1.0 2.0 3.0\n  4 5 6 ]\nutt-b [\n  7.5 -8 9e-1\n  1 2 3\n  4 5 6 ]\n",
        "u1 extra tokens [\r\n 1 2\r\n 3 4 ]\r\n",
        "u [ 0x1.8p1 -inf nan(abc) 1e-45\n 1 2 3 4 ]\ntrailing-id-without-block",
        "u [\n 1 2\v\n 3\n 4 5 6 ]",
        "u [\n 1 2\n 3 4\n]",
        "u [ 1.00000005960464477539 3.4028235677973366e38 ]",
    ], ids=["two-utts", "crlf-extra-tokens", "hex-inf-nan", "vtab-splice", "close-line", "rounding"])
    def test_features_parse_equals_jax(self, text):
        got, want = tkt.parse_features_text(text), jkt.parse_features_text(text)
        assert list(got) == list(want)
        for k in got:
            assert got[k].shape == want[k].shape and got[k].tobytes() == want[k].tobytes()

    @pytest.mark.parametrize("text", [
        "u [\n 1 2 3\n 4 5 ]\n", "u [ 1 2 x ]", "u [ ]", "u [ 1 2", "no blocks at all", "u [ 1 [ 2 ]",
    ], ids=["ragged", "garbage", "empty", "eof-after-token", "no-blocks", "second-bracket"])
    def test_features_rejections_match_jax(self, text):
        with pytest.raises(ValueError):
            jkt.parse_features_text(text)
        with pytest.raises(ValueError):
            tkt.parse_features_text(text)

    def test_python_tokenizer_equals_jax_fallback(self):
        s = " 1.5 -2e3 0x1p-2 INFINITY -nan(x1) .5e+1 \v\n7 abc"
        p = q = 0
        while True:
            (a, p2), (b, q2) = tkt._strtof_py(s, p), jkt._strtof_py(s, q)
            assert p2 == q2 and (a == b or (np.isnan(a) and np.isnan(b)))
            if p2 == p:
                break
            p = q = p2

    def test_feature_writer_and_readers(self, tmp_path):
        rng = np.random.default_rng(42)
        feats = {"a": rng.standard_normal((5, 7), dtype=np.float32),
                 "b": rng.standard_normal((2, 7), dtype=np.float32)}
        buf_t, buf_j = io.StringIO(), io.StringIO()
        tkt.write_features_text_kaldi(feats, buf_t)
        jkt.write_features_text_kaldi(feats, buf_j)
        assert buf_t.getvalue() == buf_j.getvalue()
        tkt.write_features_text_kaldi(feats, tmp_path / "f.txt")
        back = tkt.load_features_text(tmp_path / "f.txt")
        assert list(back) == ["a", "b"]
        np.testing.assert_allclose(back["a"], feats["a"], rtol=0, atol=5e-7)
        np.testing.assert_array_equal(tkt.first_utterance(tmp_path / "f.txt"), back["a"])
        np.testing.assert_array_equal(back["b"], jkt.parse_features_text(buf_j.getvalue())["b"])


class TestExtend:
    @pytest.mark.parametrize("hidden, target", [((64, 48), (128, 96)), ((100,), (256, 60))])
    def test_extend_equals_jax(self, hidden, target):
        raw = _raw(43, hidden)
        got = fdt.to_raw(fdt.extend(fdt.from_raw(raw), *target))
        want = fd.to_raw(fd.extend(fd.from_raw(raw), *target))
        _assert_raw_equal(got, want)
        assert [l.output_dim for l in got.layers] == [target[0]] * len(hidden) + [target[1]]
        # the added senones carry zero weights and bias
        assert not got.layers[-1].weights[50:].any() and not got.layers[-1].bias[50:].any()

    def test_extend_then_align_equals_jax(self):
        raw = _raw(44, (60, 60), input_dim=429)
        got = fdt.to_raw(fdt.align(fdt.extend(fdt.from_raw(raw), 100, 70), 4, 16))
        want = fd.to_raw(fd.align(fd.extend(fd.from_raw(raw), 100, 70), 4, 16))
        _assert_raw_equal(got, want)
        assert got.input_dim == 432 and got.layers[0].output_dim == 112


class TestConvertCLI:
    @pytest.mark.parametrize("extra", [[], ["--extend", "128", "80", "--align", "4", "16"]],
                             ids=["plain", "extend-align"])
    def test_model_bytes_equal_jax(self, tmp_path, text_model, extra):
        args = [str(text_model[0]), str(text_model[1])]
        assert tconvert.main(["model", *args, str(tmp_path / "t.bin"), *extra]) == 0
        assert jconvert.main(["model", *args, str(tmp_path / "j.bin"), *extra]) == 0
        assert (tmp_path / "t.bin").read_bytes() == (tmp_path / "j.bin").read_bytes()
        assert tconvert.main(["model", str(tmp_path / "t.bin"), "--from-binary",
                              str(tmp_path / "t2.bin")]) == 0
        assert (tmp_path / "t2.bin").read_bytes() == (tmp_path / "t.bin").read_bytes()

    def test_model_without_transform_fails(self, tmp_path, text_model, capsys):
        assert tconvert.main(["model", str(text_model[0]), str(tmp_path / "o.bin")]) == 2
        assert "transform file required" in capsys.readouterr().err

    @pytest.mark.parametrize("bits", ["8", "4"])
    def test_quantize_arrays_equal_jax(self, tmp_path, bits):
        fdt.write_model(_raw(45, (128, 128, 128)), tmp_path / "m.bin")
        for pkg, name in ((tconvert, "t.npz"), (jconvert, "j.npz")):
            assert pkg.main(["quantize", str(tmp_path / "m.bin"), str(tmp_path / name),
                             "--hidden-bits", bits, "--cutoff", "2.5"]) == 0
        with np.load(tmp_path / "t.npz") as t, np.load(tmp_path / "j.npz") as j:
            assert sorted(t.files) == sorted(j.files)
            for key in t.files:
                a, b = t[key], j[key]
                assert a.shape == b.shape, key
                if key == "input_b":  # the fused bias is a dot product: summation order
                    np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
                    continue
                np.testing.assert_array_equal(a, b.astype(a.dtype), err_msg=key)
                if a.dtype.kind == "f":
                    assert a.dtype == b.dtype, key
            assert int(t["bits_0"]) == int(bits) and int(t["bits_2"]) == 8
        assert fdt.load_qnet(tmp_path / "j.npz").hidden_bits == int(bits)

    @pytest.mark.parametrize("extra", [[], ["--align-dim", "4", "--max-frames", "3"],
                                       ["--utterance", "utt-b"]],
                             ids=["first", "align-max", "by-id"])
    def test_features_bytes_equal_jax(self, tmp_path, extra):
        rng = np.random.default_rng(46)
        jkt.write_features_text_kaldi(
            {"utt-a": rng.standard_normal((6, 429), dtype=np.float32),
             "utt-b": rng.standard_normal((4, 429), dtype=np.float32)}, tmp_path / "f.txt")
        for pkg, name in ((tconvert, "t.bin"), (jconvert, "j.bin")):
            assert pkg.main(["features", str(tmp_path / "f.txt"), str(tmp_path / name), *extra]) == 0
        assert (tmp_path / "t.bin").read_bytes() == (tmp_path / "j.bin").read_bytes()

    def test_features_unknown_utterance_fails(self, tmp_path, capsys):
        jkt.write_features_text_kaldi({"u": np.ones((2, 3), np.float32)}, tmp_path / "f.txt")
        assert tconvert._cli(["features", str(tmp_path / "f.txt"), str(tmp_path / "o.bin"),
                              "--utterance", "nope"]) == 2
        assert "not found" in capsys.readouterr().err


def _posteriors_close(got, want):
    assert got.shape == want.shape and np.isfinite(got).all()
    assert np.abs(got - want).max() <= POSTERIOR_ATOL
    assert (got.argmax(1) == want.argmax(1)).mean() >= ARGMAX_AGREEMENT


class TestScoreCLI:
    def test_text_input_equals_jax(self, tmp_path):
        fdt.write_model(_raw(47, (128, 128)), tmp_path / "m.bin")
        rng = np.random.default_rng(47)
        jkt.write_features_text_kaldi(
            {"utt-x": rng.standard_normal((70, 432), dtype=np.float32),
             "utt-y": rng.standard_normal((30, 432), dtype=np.float32)}, tmp_path / "f.txt")
        args = [str(tmp_path / "m.bin"), str(tmp_path / "f.txt")]
        assert jscore.main([*args, str(tmp_path / "j.txt"), "--text-input", "--backend", "xla"]) == 0
        assert tscore.main([*args, str(tmp_path / "t.txt"), "--text-input", "--device", "cpu"]) == 0
        got, want = tkt.load_features_text(tmp_path / "t.txt"), jkt.parse_features_text(
            (tmp_path / "j.txt").read_text())
        assert list(got) == list(want) == ["utt-x", "utt-y"]
        for k in got:
            _posteriors_close(got[k], want[k])

    def test_text_input_refuses_masks(self, tmp_path, capsys):
        fdt.write_model(_raw(48), tmp_path / "m.bin")
        assert tscore._cli([str(tmp_path / "m.bin"), str(tmp_path / "f.txt"), "--text-input",
                            "--mask-density", "0.4", "--device", "cpu"]) == 2
        assert "does not combine" in capsys.readouterr().err

    @pytest.mark.parametrize("packed", [False, True], ids=["unpacked", "packed"])
    def test_hidden_bits_4_equals_jax(self, tmp_path, packed):
        fdt.write_model(_raw(49, (256, 256)), tmp_path / "m.bin")
        fdt.write_features(np.random.default_rng(49).standard_normal((300, 432), dtype=np.float32),
                           tmp_path / "f.bin")
        args = [str(tmp_path / "m.bin"), str(tmp_path / "f.bin")]
        assert jscore.main([*args, str(tmp_path / "j.bin"), "BIN", "--hidden-bits", "4",
                            "--backend", "xla"]) == 0
        extra = ["--int4-packed"] if packed else []
        assert tscore.main([*args, str(tmp_path / "t.bin"), "BIN", "--hidden-bits", "4",
                            "--device", "cpu", *extra]) == 0
        _posteriors_close(fdt.read_features(tmp_path / "t.bin"), fd.read_features(tmp_path / "j.bin"))

    def test_checkpoint_bits_mismatch_fails(self, tmp_path, capsys):
        fdt.write_model(_raw(50), tmp_path / "m.bin")
        assert tconvert.main(["quantize", str(tmp_path / "m.bin"), str(tmp_path / "q4.npz"),
                              "--hidden-bits", "4"]) == 0
        fdt.write_features(np.ones((4, 432), np.float32), tmp_path / "f.bin")
        assert tscore._cli([str(tmp_path / "q4.npz"), str(tmp_path / "f.bin"),
                            "--hidden-bits", "8", "--device", "cpu"]) == 2
        assert "hidden_bits=8 requested" in capsys.readouterr().err

    def test_text_model_to_int4_posteriors_equals_jax_chain(self, tmp_path):
        """The whole front door, as users run it: Kaldi text -> convert model
        (extended) -> convert quantize --hidden-bits 4 -> score, through each
        package's CLI (the port's as a subprocess, as a user starts it)."""
        raw = _raw(51, (64, 64), out=100)
        (tmp_path / "nnet.txt").write_text(network_text(raw))
        (tmp_path / "tf.txt").write_text(transform_text(raw, splice=False))
        rng = np.random.default_rng(51)
        jkt.write_features_text_kaldi({"u": rng.standard_normal((200, 432), dtype=np.float32)},
                                      tmp_path / "feats.txt")
        outs = {}
        for tag, conv in (("t", tconvert), ("j", jconvert)):
            assert conv.main(["model", str(tmp_path / "nnet.txt"), str(tmp_path / "tf.txt"),
                              str(tmp_path / f"{tag}.bin"), "--extend", "256", "400"]) == 0
            assert conv.main(["quantize", str(tmp_path / f"{tag}.bin"),
                              str(tmp_path / f"{tag}4.npz"), "--hidden-bits", "4"]) == 0
            assert conv.main(["features", str(tmp_path / "feats.txt"),
                              str(tmp_path / f"{tag}f.bin")]) == 0
        assert (tmp_path / "t.bin").read_bytes() == (tmp_path / "j.bin").read_bytes()
        assert (tmp_path / "tf.bin").read_bytes() == (tmp_path / "jf.bin").read_bytes()
        assert jscore.main([str(tmp_path / "j4.npz"), str(tmp_path / "jf.bin"),
                            str(tmp_path / "jpost.bin"), "BIN", "--backend", "xla"]) == 0
        proc = subprocess.run(
            [sys.executable, "-m", "fastdnn_tpu_torch.cli.score", str(tmp_path / "t4.npz"),
             str(tmp_path / "tf.bin"), str(tmp_path / "tpost.bin"), "BIN", "--device", "cpu",
             "--int4-packed"],
            capture_output=True, text=True, cwd=REPO, timeout=300,
        )
        assert proc.returncode == 0, proc.stderr
        assert "(int4-trunk checkpoint)" in proc.stdout
        got = fdt.read_features(tmp_path / "tpost.bin")
        assert got.shape == (200, 400)
        _posteriors_close(got, fd.read_features(tmp_path / "jpost.bin"))

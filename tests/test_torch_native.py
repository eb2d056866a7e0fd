"""The port's native reader (formats/native.py) against its numpy parsers
and the JAX package's, after tests/test_native.py.

The module fixture builds native/fastdnn_io.cc with g++ into a temporary
directory (the port's own build; the JAX package's library is never
loaded) and skips only when no compiler exists.  Features and models must
be bitwise the numpy parsers' (the port's and the JAX package's), corrupt
files rejected with ValueError, formats/binary.py must dispatch path
arguments to the native reader unless FASTDNN_NATIVE=0, and a failed
build must raise with the compiler's output rather than fall back.  With
the compiler hidden (no $CXX, no g++ on the path) and no reader loaded,
paths take the numpy parsers bitwise, with one warning per process.
"""

import os
import shutil

import numpy as np
import pytest

import fastdnn_tpu_torch as fdt
from fastdnn_tpu.formats import binary as jbin
from fastdnn_tpu_torch.formats import binary as tbin
from fastdnn_tpu_torch.formats import kaldi_text, native

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if shutil.which("g++") is None and not os.environ.get("CXX"):
        pytest.skip("no C++ compiler")
    build_dir = tmp_path_factory.mktemp("native_build")
    native._lib = None  # build and load from the temporary directory
    loaded = native.load(build_dir)
    assert native.library_path(build_dir).is_file()
    return loaded


def _numpy_features(path):
    with open(path, "rb") as f:  # a file object takes the numpy parser
        return tbin.read_features(f)


def _numpy_model(path):
    with open(path, "rb") as f:
        return tbin.read_model(f)


def _assert_models_equal(a, b):
    assert len(a.layers) == len(b.layers)
    for x, y in zip(a.layers, b.layers):
        np.testing.assert_array_equal(x.weights, y.weights)
        np.testing.assert_array_equal(x.bias, y.bias)
    np.testing.assert_array_equal(a.shift, b.shift)
    np.testing.assert_array_equal(a.scale, b.scale)


@pytest.fixture
def feature_file(tmp_path):
    data = np.random.default_rng(3).standard_normal((257, 432), dtype=np.float32)
    data[0, :4] = [np.inf, -0.0, np.float32(1e-40), np.nan]  # specials and a subnormal
    path = tmp_path / "f.bin"
    jbin.write_features(data, path)
    return path, data


class TestBitwise:
    def test_features_equal_numpy_and_jax(self, lib, feature_file):
        path, data = feature_file
        got = native.read_features(path)
        assert got.dtype == np.float32 and got.shape == data.shape
        np.testing.assert_array_equal(got, _numpy_features(path))
        with open(path, "rb") as f:
            np.testing.assert_array_equal(got, jbin.read_features(f))
        assert np.array_equal(got.view(np.uint32), data.view(np.uint32))  # NaN bits too

    @pytest.mark.parametrize("name", ["parity_model.bin", "divergence_model.bin"])
    def test_golden_models_equal_numpy_and_jax(self, lib, name):
        path = os.path.join(GOLDEN, name)
        got = native.read_model(path)
        _assert_models_equal(got, _numpy_model(path))
        with open(path, "rb") as f:
            _assert_models_equal(got, jbin.read_model(f))
        assert got.topology() == _numpy_model(path).topology()

    def test_random_model_roundtrip(self, lib, tmp_path):
        raw = fdt.to_raw(fdt.random_net(np.random.default_rng(4), 24, [32, 32], 40))
        tbin.write_model(raw, tmp_path / "m.bin")
        _assert_models_equal(native.read_model(tmp_path / "m.bin"), raw)

    def test_write_read_roundtrip(self, lib, tmp_path):
        data = np.random.default_rng(5).standard_normal((37, 12), dtype=np.float32)
        native.write_features(data, tmp_path / "n.bin")
        np.testing.assert_array_equal(native.read_features(tmp_path / "n.bin"), data)
        tbin.write_features(data, tmp_path / "t.bin")  # the same bytes as numpy's writer
        assert (tmp_path / "n.bin").read_bytes() == (tmp_path / "t.bin").read_bytes()
        native.write_features(data[:0], tmp_path / "e.bin")
        assert native.read_features(tmp_path / "e.bin").shape == (0, 12)

    def test_text_features_equal_the_python_parser(self, lib, tmp_path):
        p = tmp_path / "feats.txt"
        p.write_text("utt-a  [\n  1.0 2.0 3.0\n  4 5 6 ]\n"
                     "utt-b [\n  7.5 -8 9e-1\n  1 2 3\n  4 5 6 ]\n")
        got = native.read_features_text(p)
        want = kaldi_text.load_features_text(p)
        assert list(got) == list(want) == ["utt-a", "utt-b"]
        for k in got:
            np.testing.assert_array_equal(got[k], want[k])


class TestRejection:
    def test_corrupt_files_rejected(self, lib, tmp_path):
        bad = tmp_path / "bad.bin"
        bad.write_bytes(b"\x00\x00")
        with pytest.raises(ValueError, match="header"):
            native.read_features(bad)
        with pytest.raises(ValueError, match="malformed"):
            native.read_model(bad)
        bad.write_bytes(np.array([5, 4], ">i4").tobytes())  # header, no data
        with pytest.raises(ValueError, match="truncated"):
            native.read_features(bad)
        model = open(os.path.join(GOLDEN, "parity_model.bin"), "rb").read()
        bad.write_bytes(model[:1000])
        with pytest.raises(ValueError, match="truncated"):
            native.read_model(bad)
        with pytest.raises(FileNotFoundError):
            native.read_features(tmp_path / "missing.bin")
        (tmp_path / "ragged.txt").write_text("u [\n 1 2 3\n 4 5 ]\n")
        with pytest.raises(ValueError):
            native.read_features_text(tmp_path / "ragged.txt")

    def test_fuzzed_features_agree_with_numpy(self, lib, feature_file, tmp_path):
        """Truncations and flipped bytes: the native reader and the numpy
        parser accept and reject the same files, and agree bitwise."""
        path, _ = feature_file
        data = path.read_bytes()
        rng = np.random.default_rng(0)
        fuzzed = tmp_path / "fuzzed.bin"
        rejected = 0
        for t in range(40):
            buf = bytearray(data)
            if t % 2 == 0:
                buf = buf[: int(rng.integers(0, len(buf)))]
            else:
                for _ in range(int(rng.integers(1, 4))):
                    buf[int(rng.integers(0, 8))] = int(rng.integers(0, 256))  # the header
            fuzzed.write_bytes(bytes(buf))
            try:
                want = _numpy_features(fuzzed)
            except ValueError:
                rejected += 1
                with pytest.raises(ValueError):
                    native.read_features(fuzzed)
                continue
            got = native.read_features(fuzzed)
            assert np.array_equal(got.view(np.uint32), want.view(np.uint32)), t
        assert rejected > 10


class TestDispatch:
    def test_paths_go_native_file_objects_and_little_endian_numpy(self, lib, feature_file,
                                                                  monkeypatch):
        path, data = feature_file
        calls = []
        read = native.read_features
        monkeypatch.setattr(native, "read_features", lambda p: calls.append(p) or read(p))
        np.testing.assert_array_equal(tbin.read_features(path), data)
        np.testing.assert_array_equal(tbin.read_features(str(path)), data)
        assert calls == [path, str(path)]
        _numpy_features(path)
        tbin.write_features(data, path.with_suffix(".le"), little_endian=True)
        np.testing.assert_array_equal(
            tbin.read_features(path.with_suffix(".le"), little_endian=True), data)
        assert len(calls) == 2

        models = []
        read_model = native.read_model
        monkeypatch.setattr(native, "read_model", lambda p: models.append(p) or read_model(p))
        raw = fdt.read_model(os.path.join(GOLDEN, "parity_model.bin"))
        assert len(models) == 1
        _assert_models_equal(raw, _numpy_model(os.path.join(GOLDEN, "parity_model.bin")))

    def test_fastdnn_native_0_takes_numpy(self, lib, feature_file, monkeypatch):
        path, data = feature_file
        monkeypatch.setenv("FASTDNN_NATIVE", "0")
        monkeypatch.setattr(native, "read_features", lambda p: pytest.fail("native called"))
        monkeypatch.setattr(native, "read_model", lambda p: pytest.fail("native called"))
        assert not native.enabled()
        np.testing.assert_array_equal(tbin.read_features(path), data)
        fdt.read_model(os.path.join(GOLDEN, "parity_model.bin"))


class TestBuild:
    def test_failed_build_raises_with_the_compiler_output(self, lib, tmp_path, monkeypatch):
        broken = tmp_path / "broken.cc"
        broken.write_text("int main( {\n")
        monkeypatch.setattr(native, "SOURCE", broken)
        with pytest.raises(RuntimeError, match="building the native reader failed") as e:
            native.build(tmp_path / "out")
        assert "error" in str(e.value)
        assert not list((tmp_path / "out").glob("*.so"))

    def test_no_compiler_raises(self, tmp_path, monkeypatch):
        monkeypatch.delenv("CXX", raising=False)
        monkeypatch.setattr(native.shutil, "which", lambda name: None)
        with pytest.raises(RuntimeError, match="FASTDNN_NATIVE=0"):
            native.build(tmp_path)

    def test_library_named_by_the_source(self, lib, tmp_path, monkeypatch):
        first = native.library_path(tmp_path)
        changed = tmp_path / "fastdnn_io.cc"
        changed.write_bytes(native.SOURCE.read_bytes() + b"\n// changed\n")
        monkeypatch.setattr(native, "SOURCE", changed)
        assert native.library_path(tmp_path) != first
        assert first.parent == tmp_path and first.suffix == ".so"



class TestNoCompiler:
    """Without a compiler and with no reader loaded, paths take the numpy
    parsers with one warning per process (the JAX package's contract);
    a compiler whose build fails still raises."""

    @pytest.fixture
    def hidden_compiler(self, monkeypatch):
        monkeypatch.delenv("CXX", raising=False)
        monkeypatch.setattr(native.shutil, "which", lambda name: None)
        monkeypatch.setattr(native, "_lib", None)
        monkeypatch.setattr(native, "_warned", False)
        monkeypatch.delenv("FASTDNN_NATIVE", raising=False)

    @pytest.mark.parametrize("name", ["parity_model.bin", "divergence_model.bin"])
    def test_model_by_path_is_the_numpy_parsers(self, hidden_compiler, name, caplog):
        path = os.path.join(GOLDEN, name)
        with caplog.at_level("WARNING", logger=native.__name__):
            got = tbin.read_model(path)
            again = fdt.read_model(path)
        _assert_models_equal(got, _numpy_model(path))
        _assert_models_equal(again, got)
        with open(path, "rb") as f:
            _assert_models_equal(got, jbin.read_model(f))
        warnings = [r for r in caplog.records if "numpy parsers" in r.getMessage()]
        assert len(warnings) == 1 and "g++ not found" in warnings[0].getMessage()
        assert native._lib is None

    def test_features_by_path_are_the_numpy_parsers(self, hidden_compiler, feature_file):
        path, data = feature_file
        got = tbin.read_features(path)
        assert got.dtype == np.float32 and got.shape == data.shape
        assert np.array_equal(got.view(np.uint32), _numpy_features(path).view(np.uint32))
        with open(path, "rb") as f:
            assert np.array_equal(got.view(np.uint32), jbin.read_features(f).view(np.uint32))
        assert np.array_equal(tbin.read_features(str(path)).view(np.uint32), data.view(np.uint32))
        assert not native.available()

    def test_a_loaded_reader_serves_without_a_compiler(self, lib, feature_file, monkeypatch):
        path, data = feature_file
        monkeypatch.setattr(native, "_lib", lib)
        monkeypatch.delenv("CXX", raising=False)
        monkeypatch.setattr(native.shutil, "which", lambda name: None)
        calls = []
        read = native.read_features
        monkeypatch.setattr(native, "read_features", lambda p: calls.append(p) or read(p))
        np.testing.assert_array_equal(tbin.read_features(path), data)
        assert calls == [path]

    def test_a_present_compiler_whose_build_fails_raises(self, lib, tmp_path, monkeypatch,
                                                          feature_file):
        broken = tmp_path / "broken.cc"
        broken.write_text("int main( {\n")
        monkeypatch.setattr(native, "SOURCE", broken)
        monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "out")
        monkeypatch.setattr(native, "_lib", None)
        with pytest.raises(RuntimeError, match="building the native reader failed"):
            tbin.read_model(os.path.join(GOLDEN, "parity_model.bin"))
        with pytest.raises(RuntimeError, match="building the native reader failed"):
            tbin.read_features(feature_file[0])
        assert not list((tmp_path / "out").glob("*.so"))

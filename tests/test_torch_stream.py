"""The port's serving path on the CPU: the streaming engine, the FDN1 server
and client, the native client and the load generator, after
tests/test_stream.py.

Bounds:
  * the port's stream against the port's serial `Scorer(device="cpu")`:
    atol 1e-6, as the JAX package holds its stream to its Scorer (each row's
    arithmetic does not depend on its batch neighbours, so it is equal in
    practice);
  * the port's stream against the JAX package's StreamingScorer on the same
    quantized net, carried across as numpy arrays: 1e-4 with argmax
    agreement >= 0.999 (the from-frames bound: the float input layer's f32
    summation order may move a sigmoid count by one, rarely);
  * byte compatibility: either package's client against the other's server
    gets what that server's own serial scorer gives, within 1e-6.
"""

import os
import shutil
import socket
import struct
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import fastdnn_tpu as fd
import fastdnn_tpu_torch as fdt
from fastdnn_tpu.cli import serve as jserve
from fastdnn_tpu.engine.stream import StreamingScorer as JaxStreamingScorer
from fastdnn_tpu_torch.cli import bench_serve
from fastdnn_tpu_torch.cli import serve
from fastdnn_tpu_torch.engine.stream import StreamingScorer
from fastdnn_tpu_torch.utils import timer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POSTERIOR_ATOL = 1e-4
ARGMAX_AGREEMENT = 0.999


def _carry(j_q, tmp_path):
    """A JAX QuantizedNet -> the port, through the checkpoint arrays."""
    fd.save_qnet(j_q, tmp_path / "q.npz")
    with np.load(tmp_path / "q.npz") as z:
        return fdt.qnet_from_arrays({k: np.asarray(z[k]) for k in z.files})


@pytest.fixture(scope="module")
def nets(small_net, tmp_path_factory):
    j_q = fd.quantize_net(small_net)
    return j_q, _carry(j_q, tmp_path_factory.mktemp("q"))


@pytest.fixture(scope="module")
def scorer(nets):
    return fdt.Scorer(nets[1], device="cpu")


@pytest.fixture()
def stream(scorer):
    with StreamingScorer(scorer, max_batch_frames=256, max_wait_ms=10.0) as ss:
        yield ss


def rand_utts(rng, count, dim, lo=3, hi=40):
    return [
        rng.standard_normal((int(rng.integers(lo, hi)), dim)).astype(np.float32)
        for _ in range(count)
    ]


def _join_all(threads, timeout=120):
    for t in threads:
        t.join(timeout)
    assert not any(t.is_alive() for t in threads), "a thread did not finish"


class TestStreamingScorer:
    def test_matches_direct_scoring(self, stream, scorer, rng):
        utts = rand_utts(rng, 12, scorer.input_dim)
        futs = [stream.submit(u) for u in utts]
        for u, f in zip(utts, futs):
            np.testing.assert_allclose(f.result(timeout=60), scorer.score(u), atol=1e-6)

    def test_many_threads(self, stream, scorer, rng):
        utts = rand_utts(rng, 32, scorer.input_dim)
        results = [None] * len(utts)
        errors = []

        def worker(lo, hi):
            try:
                futs = [(i, stream.submit(utts[i])) for i in range(lo, hi)]
                for i, f in futs:
                    results[i] = f.result(timeout=60)
            except Exception as e:  # pragma: no cover
                errors.append(e)

        threads = [threading.Thread(target=worker, args=(i * 8, (i + 1) * 8)) for i in range(4)]
        for t in threads:
            t.start()
        _join_all(threads)
        assert not errors
        for u, r in zip(utts, results):
            np.testing.assert_allclose(r, scorer.score(u), atol=1e-6)
        assert stream.throughput.frames == sum(u.shape[0] for u in utts)

    def test_masked_submissions(self, stream, scorer, rng):
        u = rng.standard_normal((7, scorer.input_dim)).astype(np.float32)
        masks = (rng.random((7, scorer.output_dim)) < 0.4).astype(np.uint8)
        got = stream.submit(u, masks).result(timeout=60)
        np.testing.assert_allclose(got, scorer.score_masked(u, masks), atol=1e-6)

    def test_mixed_masked_and_plain(self, stream, scorer, rng):
        u1 = rng.standard_normal((5, scorer.input_dim)).astype(np.float32)
        u2 = rng.standard_normal((6, scorer.input_dim)).astype(np.float32)
        masks = (rng.random((6, scorer.output_dim)) < 0.5).astype(np.uint8)
        f1 = stream.submit(u1)
        f2 = stream.submit(u2, masks)
        np.testing.assert_allclose(f1.result(60), scorer.score(u1), atol=1e-6)
        np.testing.assert_allclose(f2.result(60), scorer.score_masked(u2, masks), atol=1e-6)

    def test_narrow_frames_pad_like_the_scorer(self, stream, scorer, rng):
        """Utterances narrower than the input width share a batch with full
        ones; each is zero-padded as Scorer.score pads it."""
        narrow = rng.standard_normal((4, scorer.input_dim - 32)).astype(np.float32)
        full = rng.standard_normal((5, scorer.input_dim)).astype(np.float32)
        f1, f2 = stream.submit(narrow), stream.submit(full)
        np.testing.assert_allclose(f1.result(60), scorer.score(narrow), atol=1e-6)
        np.testing.assert_allclose(f2.result(60), scorer.score(full), atol=1e-6)

    def test_gathered_lazy_mode(self, nets, rng):
        sc = fdt.Scorer(nets[1], fdt.EngineConfig(lazy_mode="gathered", lazy_capacity=1.0),
                        device="cpu")
        dense = fdt.Scorer(nets[1], device="cpu")
        utts = rand_utts(rng, 3, sc.input_dim)
        masks = [(rng.random((u.shape[0], sc.output_dim)) < 0.3).astype(np.uint8) for u in utts]
        with StreamingScorer(sc, max_batch_frames=256) as ss:
            futs = [ss.submit(u, m) for u, m in zip(utts, masks)]
            for u, m, f in zip(utts, masks, futs):
                np.testing.assert_allclose(f.result(60), dense.score_masked(u, m), atol=2e-6)

    def test_concurrent_load_batches_fill(self, scorer, rng):
        """Under concurrent load the packer puts more than one utterance in
        a dispatch: mean batch fill above one utterance's frames, fewer
        batches than utterances."""
        utts = rand_utts(rng, 48, scorer.input_dim, lo=8, hi=16)
        with StreamingScorer(scorer, max_batch_frames=4096, max_wait_ms=80.0) as ss:
            barrier = threading.Barrier(8)
            futs: list = [None] * len(utts)

            def worker(t):
                barrier.wait()  # all submitters hit the queue together
                for i in range(t, len(utts), 8):
                    futs[i] = ss.submit(utts[i])

            threads = [threading.Thread(target=worker, args=(t,)) for t in range(8)]
            for th in threads:
                th.start()
            _join_all(threads)
            for u, f in zip(utts, futs):
                np.testing.assert_allclose(f.result(timeout=60), scorer.score(u), atol=1e-6)
            tp = ss.throughput
        assert tp.batches < len(utts), (tp.batches, len(utts))
        assert tp.mean_batch_fill() > max(u.shape[0] for u in utts)

    def test_oversized_utterance_rejected(self, stream, scorer):
        with pytest.raises(ValueError, match="exceeds"):
            stream.submit(np.zeros((257, scorer.input_dim), np.float32))

    def test_bad_mask_shape_rejected(self, stream, scorer):
        with pytest.raises(ValueError, match="masks"):
            stream.submit(np.zeros((4, scorer.input_dim), np.float32), np.zeros((4, 3), np.uint8))

    def test_closed_rejects(self, scorer):
        ss = StreamingScorer(scorer)
        ss.close()
        with pytest.raises(RuntimeError):
            ss.submit(np.zeros((2, scorer.input_dim), np.float32))

    def test_too_wide_frames_rejected(self, stream, scorer):
        with pytest.raises(ValueError, match="network input size"):
            stream.submit(np.zeros((2, scorer.input_dim + 1), np.float32))

    def test_errors_reach_every_future_and_spare_the_worker(self, nets, rng):
        """A failing batch fails each future of its group and only those;
        a cancelled future does not stop the worker either."""
        sc = fdt.Scorer(nets[1], device="cpu")
        real_run = sc._run
        calls = []

        def failing_once(frames):
            calls.append(frames.shape[0])
            if len(calls) == 1:
                raise RuntimeError("device fault")
            return real_run(frames)

        sc._run = failing_once
        utts = rand_utts(rng, 3, sc.input_dim)
        with StreamingScorer(sc, max_batch_frames=256, max_wait_ms=200.0) as ss:
            bad = [ss.submit(u) for u in utts]
            for f in bad:
                with pytest.raises(RuntimeError, match="device fault"):
                    f.result(60)
            cancelled = ss.submit(utts[0])
            cancelled.cancel()
            good = ss.submit(utts[1])
            np.testing.assert_allclose(good.result(60), sc.score(utts[1]), atol=1e-6)

    @pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
    def test_a_dead_worker_fails_every_waiting_future(self, scorer, rng):
        """A failure outside a batch's error handling ends the worker; every
        future it held or left queued fails with it, and submit refuses."""

        class Fatal(BaseException):
            pass

        class Broken(StreamingScorer):
            def _dispatch(self, group, slot):
                raise Fatal("worker lost")

        utts = rand_utts(rng, 3, scorer.input_dim)
        ss = Broken(scorer, max_batch_frames=256, max_wait_ms=50.0)
        futs = [ss.submit(u) for u in utts]
        for f in futs:
            with pytest.raises(Fatal):
                f.result(60)
        ss._worker.join(60)
        assert not ss._worker.is_alive()
        with pytest.raises(RuntimeError, match="closed"):
            ss.submit(utts[0])

    def test_mesh_scorer_refused(self, scorer):
        class Meshed:
            mesh = object()

        with pytest.raises(ValueError, match="single-device"):
            StreamingScorer(Meshed())

    def test_matches_jax_stream(self, nets, rng):
        j_q, t_q = nets
        utts = rand_utts(rng, 10, 432, lo=20, hi=120)
        masks = [(rng.random((u.shape[0], j_q.output_dim)) < 0.3).astype(np.uint8)
                 for u in utts[:4]]
        jsc = fd.Scorer(j_q, fd.EngineConfig(backend="xla"))
        with JaxStreamingScorer(jsc, max_batch_frames=512) as js:
            jfuts = [js.submit(u) for u in utts] + [js.submit(u, m) for u, m in zip(utts, masks)]
            want = [f.result(120) for f in jfuts]
        with StreamingScorer(fdt.Scorer(t_q, device="cpu"), max_batch_frames=512) as ts:
            tfuts = [ts.submit(u) for u in utts] + [ts.submit(u, m) for u, m in zip(utts, masks)]
            got = [f.result(120) for f in tfuts]
        got, want = np.concatenate(got), np.concatenate(want)
        assert got.shape == want.shape and got.dtype == np.float32
        assert np.abs(got - want).max() <= POSTERIOR_ATOL
        assert (got.argmax(1) == want.argmax(1)).mean() >= ARGMAX_AGREEMENT


class TestTimer:
    def test_throughput_counts(self):
        tp = timer.Throughput()
        for n in (100, 300):
            tp.add(n)
        assert (tp.frames, tp.batches, tp.mean_batch_fill()) == (400, 2, 200.0)
        assert tp.audio_seconds_per_s() == pytest.approx(tp.frames_per_s() / 100.0)
        tp.reset()
        assert (tp.frames, tp.batches, tp.frames_per_s()) == (0, 0, 0.0)

    def test_trace_writes_a_chrome_trace(self, tmp_path):
        with timer.trace(str(tmp_path / "t")):
            torch.ones(64).sum()
        assert (tmp_path / "t" / "trace.json").stat().st_size > 0
        with timer.Timer() as t:
            pass
        assert t.ms >= 0


@pytest.fixture(scope="module")
def model_path(small_net, tmp_path_factory):
    path = tmp_path_factory.mktemp("srv") / "model.bin"
    fd.write_model(fd.to_raw(small_net), path)
    return path


@pytest.fixture(scope="module")
def served(model_path):
    """(the port's server from the model file, its serial oracle)."""

    class A:
        model = str(model_path)
        host, port = "127.0.0.1", 0  # ephemeral
        cutoff, device = 3.0, "cpu"
        max_batch_frames, max_wait_ms = 256, 5.0

    srv = serve.make_server(A)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield srv, fdt.Scorer(fdt.load_quantized(model_path)[0], device="cpu")
    srv.shutdown()
    srv.server_close()
    srv.stream.close()


def _raw_exchange(host, port, blob: bytes) -> bytes:
    s = socket.create_connection((host, port), timeout=10)
    s.settimeout(10)
    try:
        s.sendall(blob)
        status = s.recv(1)
        (ln,) = struct.unpack("<I", s.recv(4))
        return status + s.recv(ln)
    finally:
        s.close()


class TestScoreServer:
    def test_roundtrip_and_stats(self, served, rng):
        srv, oracle = served
        c = serve.ScoreClient(*srv.server_address[:2])
        u = rng.standard_normal((9, oracle.input_dim)).astype(np.float32)
        np.testing.assert_allclose(c.score(u), oracle.score(u), atol=1e-6)
        masks = (rng.random((9, oracle.output_dim)) < 0.4).astype(np.uint8)
        np.testing.assert_allclose(c.score(u, masks), oracle.score_masked(u, masks), atol=1e-6)
        stats = c.stats()
        assert stats["frames"] >= 18
        assert set(stats) == {"frames", "batches", "mean_batch_fill", "frames_per_s",
                              "audio_seconds_per_s", "input_dim", "output_dim"}
        assert (stats["input_dim"], stats["output_dim"]) == (oracle.input_dim, oracle.output_dim)
        c.close()

    def test_concurrent_clients(self, served, rng):
        srv, oracle = served
        utts = rand_utts(rng, 16, oracle.input_dim)
        results = [None] * len(utts)

        def worker(ids):
            c = serve.ScoreClient(*srv.server_address[:2])
            for i in ids:
                results[i] = c.score(utts[i])
            c.close()

        threads = [threading.Thread(target=worker, args=(range(i * 4, (i + 1) * 4),))
                   for i in range(4)]
        for t in threads:
            t.start()
        _join_all(threads)
        for u, r in zip(utts, results):
            np.testing.assert_allclose(r, oracle.score(u), atol=1e-6)

    def test_bad_magic(self, served):
        reply = _raw_exchange(*served[0].server_address[:2], b"XXXX\x01")
        assert reply[0] == 1 and b"magic" in reply[1:]

    def test_unknown_op_rejected_before_any_body(self, served):
        """An unknown op is answered at once (no body is read), and the
        connection stays usable."""
        srv, oracle = served
        s = socket.create_connection(srv.server_address[:2], timeout=10)
        try:
            s.sendall(serve.MAGIC + b"\x09")
            assert s.recv(1) == b"\x01"
            (ln,) = struct.unpack("<I", s.recv(4))
            assert b"unknown op 9" in s.recv(ln)
            s.sendall(serve.MAGIC + struct.pack("<B", serve.OP_STATS))
            assert s.recv(1) == b"\x00"
        finally:
            s.close()

    def test_oversized_dim_rejected_before_payload(self, served):
        srv, oracle = served
        c = serve.ScoreClient(*srv.server_address[:2])
        with pytest.raises(RuntimeError, match="bad frame count/dim"):
            c.score(np.zeros((2, oracle.input_dim + 64), np.float32))
        c.close()

    def test_jax_client_against_port_server(self, served, rng):
        srv, oracle = served
        c = jserve.ScoreClient(*srv.server_address[:2])
        u = rng.standard_normal((11, oracle.input_dim)).astype(np.float32)
        masks = (rng.random((11, oracle.output_dim)) < 0.3).astype(np.uint8)
        np.testing.assert_allclose(c.score(u), oracle.score(u), atol=1e-6)
        np.testing.assert_allclose(c.score(u, masks), oracle.score_masked(u, masks), atol=1e-6)
        assert c.stats()["output_dim"] == oracle.output_dim
        c.close()

    def test_port_client_against_jax_server(self, model_path, rng):
        from fastdnn_tpu.quant.serialize import load_quantized

        jsc = fd.Scorer(load_quantized(model_path)[0], fd.EngineConfig(backend="xla"))
        stream = JaxStreamingScorer(jsc, max_batch_frames=256)
        srv = jserve.ScoreServer(("127.0.0.1", 0), stream)
        t = threading.Thread(target=srv.serve_forever, daemon=True)
        t.start()
        try:
            c = serve.ScoreClient(*srv.server_address[:2])
            u = rng.standard_normal((11, jsc.input_dim)).astype(np.float32)
            masks = (rng.random((11, jsc.output_dim)) < 0.3).astype(np.uint8)
            np.testing.assert_allclose(c.score(u), jsc.score(u), atol=1e-6)
            np.testing.assert_allclose(c.score(u, masks), jsc.score_masked(u, masks), atol=1e-6)
            assert c.stats()["input_dim"] == jsc.input_dim
            with pytest.raises(RuntimeError, match="bad frame count/dim"):
                c.score(np.zeros((2, jsc.input_dim + 64), np.float32))
            c.close()
        finally:
            srv.shutdown()
            srv.server_close()
            stream.close()

    def test_native_client_against_port_server(self, served, tmp_path):
        """`fastdnn-io score HOST:PORT`, built from native/ into a temporary
        directory, against the port's server."""
        if shutil.which("g++") is None:
            pytest.skip("no g++ to build the native client")
        cli = tmp_path / "fastdnn-io"
        src = os.path.join(REPO, "native")
        subprocess.run(["g++", "-O2", "-std=c++17", "-o", str(cli),
                        os.path.join(src, "fastdnn_io_cli.cc"), os.path.join(src, "fastdnn_io.cc")],
                       check=True, capture_output=True, timeout=300)
        srv, oracle = served
        frames = np.random.default_rng(0).standard_normal((23, oracle.input_dim)).astype(np.float32)
        fpath, opath = tmp_path / "f.bin", tmp_path / "p.bin"
        fdt.write_features(frames, fpath)
        host, port = srv.server_address[:2]
        r = subprocess.run([str(cli), "score", f"{host}:{port}", str(fpath), str(opath), "BIN"],
                           capture_output=True, text=True, timeout=120)
        assert r.returncode == 0, r.stderr
        np.testing.assert_allclose(fdt.read_features(opath), oracle.score(frames), atol=1e-6)


def test_serve_protocol_garbage_fuzz(nets, rng):
    """Random garbage byte streams against the handler: a clean error or a
    dropped connection, never a wedged worker, and the server stays usable."""
    scorer = fdt.Scorer(nets[1], device="cpu")
    stream = StreamingScorer(scorer, max_batch_frames=128)
    server = serve.ScoreServer(("127.0.0.1", 0), stream)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        host, port = server.server_address[:2]
        for trial in range(25):
            blob = rng.bytes(int(rng.integers(1, 200)))
            if trial % 3 == 0:
                blob = serve.MAGIC + blob  # valid magic, garbage op/dims/payload
            s = socket.create_connection((host, port), timeout=10)
            s.settimeout(5)
            try:
                s.sendall(blob)
                s.shutdown(socket.SHUT_WR)  # half-close: header reads must bail
                while s.recv(4096):
                    pass
            except OSError:
                pass  # reset by the server is an acceptable outcome
            finally:
                s.close()
        c = serve.ScoreClient(host, port)
        u = rng.standard_normal((3, scorer.input_dim)).astype(np.float32)
        np.testing.assert_allclose(c.score(u), scorer.score(u), atol=1e-6)
        c.close()
    finally:
        server.shutdown()
        server.server_close()
        stream.close()


class TestCommandLine:
    def test_parser_is_single_device(self):
        """Without a mesh flag or --coordinator the server is single-device
        (the multi-process flags are tests/test_torch_service.py's); the JAX
        CLI's --backend has no counterpart."""
        args = serve.build_parser().parse_args(["m.bin"])
        assert (args.device, args.port, args.max_batch_frames, args.max_wait_ms) == (
            "cuda", 8477, 8192, 3.0)
        assert (args.mesh_model, args.mesh_data, args.coordinator) == (0, None, None)
        assert not serve._multi(args)
        with pytest.raises(SystemExit):
            serve.build_parser().parse_args(["m.bin", "--backend", "1"])

    def test_serve_device_cuda_without_cuda_fails(self, model_path, monkeypatch, capsys):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        assert serve._cli([str(model_path), "--port", "0"]) == 2
        assert "CUDA is not available" in capsys.readouterr().err

    def test_default_model_is_the_bench_net(self, tmp_path):
        path = bench_serve.write_default_model(tmp_path / "m.bin")
        raw = fdt.read_model(path)
        assert [(layer.input_dim, layer.output_dim) for layer in raw.layers] == (
            [(432, 1024)] + [(1024, 1024)] * 4 + [(1024, 4000)])

    def test_bench_serve_spawns_a_cpu_server(self, model_path, capsys):
        """bench_serve's main: spawn `python -m fastdnn_tpu_torch.cli.serve
        --device cpu`, drive it, print one JSON line, stop the server."""
        import json

        assert bench_serve.main(["--model", str(model_path), "--device", "cpu",
                                 "--clients", "2", "--duration-s", "1",
                                 "--min-len", "5", "--max-len", "20"]) == 0
        row = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert row["clients"] == 2 and row["utterances"] > 0 and row["mean_batch_fill"] > 0
        assert set(row) >= {"audio_s_per_s", "p50_ms", "p90_ms", "p99_ms", "max_wait_ms"}

    def test_run_load_keeps_checkable_responses(self, served):
        srv, oracle = served
        row = bench_serve.run_load(srv.server_address[1], clients=3, duration_s=0.5, min_len=5,
                                   max_len=30, masked_frac=0.34, mask_density=0.08, keep=2)
        per_client = row.pop("responses")
        assert [len(kept) for kept in per_client] == [2, 2, 2]
        responses = [r for kept in per_client for r in kept]
        assert sum(m is not None for _, m, _ in responses) == 2
        for f, m, out in responses:
            want = oracle.score(f) if m is None else oracle.score_masked(f, m)
            np.testing.assert_allclose(out, want, atol=1e-6)


class TestGuards:
    def test_no_jax_in_the_serving_modules_or_chip_smoke(self):
        paths = [os.path.join(REPO, "chip_smoke.py")] + [
            os.path.join(REPO, "fastdnn_tpu_torch", *p) for p in
            (("engine", "stream.py"), ("cli", "serve.py"), ("cli", "bench_serve.py"),
             ("utils", "timer.py"))]
        for path in paths:
            text = open(path).read()
            for banned in ("import jax", "from jax", "ml_dtypes", "import fastdnn_tpu\n",
                           "from fastdnn_tpu.", "from fastdnn_tpu import"):
                assert banned not in text, f"{path}: {banned!r}"

    def test_serving_imports_with_jax_blocked(self):
        code = (
            "import sys\n"
            "for m in ('jax', 'jaxlib', 'ml_dtypes'): sys.modules[m] = None\n"
            "import fastdnn_tpu_torch.engine.stream, fastdnn_tpu_torch.cli.serve\n"
            "import fastdnn_tpu_torch.cli.bench_serve, fastdnn_tpu_torch.utils.timer\n"
            "import chip_smoke\n"
            "assert not any(m == 'fastdnn_tpu' or m.startswith(('fastdnn_tpu.', 'jax'))\n"
            "               for m in sys.modules if sys.modules[m] is not None)\n"
            "print('ok')\n"
        )
        proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                              cwd=REPO, timeout=300)
        assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs the same checks on the card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_stream_on_card_matches_serial(nets, cuda_device, rng):
    sc = fdt.Scorer(nets[1], device=cuda_device)
    utts = rand_utts(rng, 24, sc.input_dim, lo=20, hi=300)
    masks = [(rng.random((u.shape[0], sc.output_dim)) < 0.08).astype(np.uint8) for u in utts]
    with StreamingScorer(sc, max_batch_frames=1024, max_wait_ms=5.0) as ss:
        futs = [ss.submit(u, m if i % 4 == 0 else None)
                for i, (u, m) in enumerate(zip(utts, masks))]
        got = [f.result(120) for f in futs]
        assert ss.throughput.frames == sum(u.shape[0] for u in utts)
    for i, (u, m, g) in enumerate(zip(utts, masks, got)):
        want = sc.score_masked(u, m) if i % 4 == 0 else sc.score(u)
        assert np.abs(g - want).max() <= 3e-5


@pytest.mark.cuda
def test_server_on_card_matches_serial(nets, cuda_device, rng):
    sc = fdt.Scorer(nets[1], device=cuda_device)
    with StreamingScorer(sc, max_batch_frames=1024) as ss:
        srv = serve.ScoreServer(("127.0.0.1", 0), ss)
        t = threading.Thread(target=srv.serve_forever, daemon=True)
        t.start()
        try:
            c = serve.ScoreClient(*srv.server_address[:2])
            u = rng.standard_normal((300, sc.input_dim)).astype(np.float32)
            assert np.abs(c.score(u) - sc.score(u)).max() <= 3e-5
            c.close()
        finally:
            srv.shutdown()
            srv.server_close()

"""The port's multi-process serving path against the JAX package, on CPU:
MultiHostScorer (parallel/service.py), StreamingScorer over a coordinator,
make_gspmd_scorer, and the mesh front doors of the score and serve CLIs.

One module-scoped fixture per mesh shape (data x model = 1x2, 2x1) spawns
two gloo ranks once (torch.multiprocessing, tests/torch_service_worker.py):
rank 0 coordinates a MultiHostScorer through every case and serves it over
TCP while rank 1 runs worker_loop(); then both run the plain SPMD
`Scorer(mesh=...)` and make_gspmd_scorer.  The ranks import no JAX.  The
coordinator's posteriors must be bitwise those of the plain mesh Scorer on
the same mesh, scatter bitwise the same as broadcast, and all within 1e-4
(argmax agreement >= 0.999; masked 3e-5) of JAX's `Scorer(mesh=...)` on the
virtual CPU devices.  Net: 432 -> 2x128 -> 300.  Then: a worker that dies,
the watchdog cases of tests/test_multihost.py on one process, and the two
CLIs as subprocesses (two serve ranks, a torchrun score).
"""

import os
import re
import signal
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

import fastdnn_tpu as fd
import fastdnn_tpu_torch as fdt
import torch_service_worker
from fastdnn_tpu.parallel import mesh as jmesh
from fastdnn_tpu_torch.cli import score as score_cli
from fastdnn_tpu_torch.cli import serve
from fastdnn_tpu_torch.parallel import service
from fastdnn_tpu_torch.parallel.mesh import make_mesh

POSTERIOR_ATOL = 1e-4
MASKED_ATOL = 3e-5
ARGMAX_AGREEMENT = 0.999
RANK_TIMEOUT_S = 120
OUT = 300
SEMANTICS = ["reference", "active_only"]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _assert_close(got, want, atol=POSTERIOR_ATOL):
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= atol
    assert (got.argmax(1) == want.argmax(1)).mean() >= ARGMAX_AGREEMENT


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def j_q():
    t_net = fdt.random_net(np.random.default_rng(9), 432, [128, 128], OUT)
    return fd.quantize_net(fd.from_raw(fdt.to_raw(t_net)))


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(10)
    masks = (rng.random((100, OUT)) < 0.4).astype(np.uint8)
    masks[7] = 0  # a frame with no active senone
    return {"frames": rng.standard_normal((100, 432), dtype=np.float32), "masks": masks}


def _spawn(work, data, model, mode):
    """Spawn the two ranks in `mode` -> their processes, joined (a hung rank
    fails the test)."""
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=torch_service_worker.run,
                         args=(r, 2, data, model, str(work), mode)) for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(RANK_TIMEOUT_S)
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errors = {r: (work / f"rank{r}.err").read_text() for r in range(2)
              if (work / f"rank{r}.err").exists()}
    assert not hung, f"ranks {hung} did not finish within {RANK_TIMEOUT_S} s; errors: {errors}"
    return procs, errors


def _write_inputs(work, j_q, inputs):
    fd.save_qnet(j_q, work / "q.npz")
    np.savez(work / "inputs.npz", **inputs)


@pytest.fixture(scope="module", params=[(1, 2), (2, 1)], ids=["1x2", "2x1"])
def ranks(request, j_q, inputs, tmp_path_factory):
    """-> (data, model, rank 0's results, rank 1's results)."""
    data, model = request.param
    work = tmp_path_factory.mktemp(f"service{data}x{model}")
    _write_inputs(work, j_q, inputs)
    procs, errors = _spawn(work, data, model, "cases")
    assert all(p.exitcode == 0 for p in procs) and not errors, errors
    results = []
    for r in range(2):
        with np.load(work / f"rank{r}.npz") as z:
            results.append({k: z[k] for k in z.files})
    return data, model, results[0], results[1]


def _jax_scorer(j_q, data=None, model=None, **cfg):
    mesh = None
    if data is not None:
        import jax

        mesh = jmesh.make_mesh(data=data, model=model, devices=jax.devices()[: data * model])
    return fd.Scorer(j_q, fd.EngineConfig(backend="xla", **cfg), mesh=mesh)


@pytest.mark.parametrize("semantics", SEMANTICS)
def test_coordinator_bitwise_the_plain_mesh_scorer(ranks, semantics):
    """The coordinated calls run the plain mesh Scorer's programs on the
    same rows: bitwise the same posteriors."""
    _, _, res, _ = ranks
    np.testing.assert_array_equal(res[f"{semantics}_masked"], res[f"plain_{semantics}_masked"])
    np.testing.assert_array_equal(res[f"{semantics}_score"], res[f"plain_{semantics}_score"])
    np.testing.assert_array_equal(res["lazy_rows"], res["plain_lazy_rows"])


def test_scatter_bitwise_broadcast(ranks):
    _, _, res, _ = ranks
    np.testing.assert_array_equal(res["broadcast_score"], res["reference_score"])
    np.testing.assert_array_equal(res["broadcast_masked"], res["reference_masked"])


def test_score_matches_jax_mesh(ranks, j_q, inputs):
    data, model, res, _ = ranks
    frames = inputs["frames"]
    _assert_close(res["reference_score"], _jax_scorer(j_q, data, model).score(frames))
    _assert_close(res["reference_score"], _jax_scorer(j_q).score(frames))
    _assert_close(res["utterances"], _jax_scorer(j_q).score(frames[:24]))


@pytest.mark.parametrize("semantics", SEMANTICS)
def test_score_masked_matches_jax_mesh(ranks, j_q, inputs, semantics):
    data, model, res, _ = ranks
    frames, masks = inputs["frames"], inputs["masks"]
    want = _jax_scorer(j_q, data, model, lazy_semantics=semantics).score_masked(frames, masks)
    got = res[f"{semantics}_masked"]
    _assert_close(got, want, MASKED_ATOL)
    if semantics == "active_only":
        np.testing.assert_array_equal(got[7], 0.0)  # the fully masked frame


def test_lazy_context_through_the_coordinator(ranks, j_q, inputs):
    _, _, res, _ = ranks
    frames, masks = inputs["frames"], inputs["masks"]
    want = _jax_scorer(j_q).score_masked(frames[:3], masks[:3])
    _assert_close(res["lazy_rows"], want, MASKED_ATOL)


def test_tcp_serving_over_the_coordinator(ranks, j_q, inputs):
    """ScoreServer + StreamingScorer over the coordinator, through a socket
    client, against the single-device JAX engine (as
    tests/multihost_worker.py's serve mode)."""
    _, _, res, _ = ranks
    frames, masks = inputs["frames"], inputs["masks"]
    single = _jax_scorer(j_q)
    for i, (lo, hi) in enumerate(((0, 9), (9, 26), (26, 31))):
        _assert_close(res[f"served{i}"], single.score(frames[lo:hi]))
    _assert_close(res["served_masked"], single.score_masked(frames[:9], masks[:9]), MASKED_ATOL)
    assert int(res["served_output_dim"]) == OUT


def test_stream_refuses_plain_mesh_and_worker(ranks):
    _, _, res, worker = ranks
    assert bool(res["stream_refuses_plain_mesh"])
    assert bool(worker["stream_refuses_worker"])


def test_input_precision_reaches_every_rank(ranks, j_q, inputs):
    """MultiHostScorers built with input_precision="default" on every rank:
    the coordinator's posteriors are bitwise the plain mesh Scorer's under
    the same knob, make_gspmd_scorer carries it too, and all are within
    1e-4 of JAX scoring bf16-rounded frames with a bf16-rounded input weight
    (JAX on the CPU ignores the knob)."""
    import dataclasses

    import jax.numpy as jnp

    _, _, res, _ = ranks
    frames, masks = inputs["frames"], inputs["masks"]
    np.testing.assert_array_equal(res["bf16_input_score"], res["plain_bf16_input_score"])
    np.testing.assert_array_equal(res["bf16_input_masked"], res["plain_bf16_input_masked"])

    def bf16(x):
        return jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32)

    rounded = _jax_scorer(dataclasses.replace(j_q, input_w=bf16(j_q.input_w)))
    want = rounded.score(np.asarray(bf16(frames)))
    _assert_close(res["bf16_input_score"], want)
    _assert_close(res["gspmd_bf16_input_score"], want)
    _assert_close(res["bf16_input_masked"], rounded.score_masked(np.asarray(bf16(frames)), masks),
                  MASKED_ATOL)
    assert np.abs(res["bf16_input_score"] - res["reference_score"]).max() > 0


def test_make_gspmd_scorer_matches_jax(ranks, j_q, inputs):
    """make_gspmd_scorer: the whole posteriors on every rank (rank 0's
    shown), against JAX's make_gspmd_scorer on the virtual devices and the
    single-device JAX Scorer."""
    import jax

    from fastdnn_tpu.parallel.sharded import make_gspmd_scorer

    data, model, res, _ = ranks
    frames, masks = inputs["frames"], inputs["masks"]
    np.testing.assert_array_equal(res["gspmd_score_again"], res["gspmd_score"])
    single = _jax_scorer(j_q)
    _assert_close(res["gspmd_score"], single.score(frames))
    _assert_close(res["gspmd_masked"], single.score_masked(frames, masks), MASKED_ATOL)
    jm = jmesh.make_mesh(data=data, model=model, devices=jax.devices()[: data * model])
    j_score, _ = make_gspmd_scorer(jm, out_dim=OUT)
    _assert_close(res["gspmd_score"], np.asarray(j_score(j_q, frames)))


def test_dead_worker_surfaces_a_runtime_error(j_q, inputs, tmp_path):
    """Rank 1 dies after its first call without a stop op: the next call
    raises RuntimeError within call_timeout_s (gloo may raise at once on
    the closed peer), the scorer ends closed, and later calls fail fast."""
    _write_inputs(tmp_path, j_q, inputs)
    procs, errors = _spawn(tmp_path, 1, 2, "death")
    assert procs[0].exitcode == 0 and not errors, errors
    assert procs[1].exitcode == 17  # the simulated crash
    with np.load(tmp_path / "rank0.npz") as z:
        res = {k: z[k] for k in z.files}
    _assert_close(res["first"], _jax_scorer(j_q).score(inputs["frames"][:16]))
    assert str(res["err"]) and float(res["dead_s"]) <= torch_service_worker.DEATH_TIMEOUT_S + 10
    assert "closed" in str(res["fast"]) and float(res["fast_s"]) < 1.0
    assert bool(res["closed"])


# -- the watchdog on one process (tests/test_multihost.py's cases) --------------


@pytest.fixture
def one_rank(tmp_path):
    """A one-rank gloo group in this process, destroyed after the test."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rendezvous'}",
                            world_size=1, rank=0)
    try:
        yield make_mesh(1, 1, device_type="cpu")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def small_q():
    return fdt.quantize_net(fdt.random_net(np.random.default_rng(6), 32, [64], 64))


def test_one_process_behaves_as_the_mesh_scorer(one_rank, small_q):
    frames = np.random.default_rng(1).standard_normal((10, 32), dtype=np.float32)
    sc = service.MultiHostScorer(small_q, fdt.EngineConfig(), one_rank, device="cpu",
                                 heartbeat_s=0)
    want = fdt.Scorer(small_q, fdt.EngineConfig(), device="cpu", mesh=one_rank).score(frames)
    np.testing.assert_array_equal(sc.score(frames), want)
    sc.worker_loop()  # inert on one process
    sc.close()
    with pytest.raises(ValueError, match="requires a mesh"):
        service.MultiHostScorer(small_q, device="cpu")


def test_watchdog_first_of_kind_key_allowance(one_rank, small_q):
    """Every first-of-its-kind (program, shape) key gets the larger
    first_call_timeout_s, repeat keys the steady call_timeout_s; expiry in
    a one-process scorer degrades cleanly (no lock to release)."""
    def scorer():
        return service.MultiHostScorer(
            small_q, fdt.EngineConfig(), one_rank, device="cpu",
            heartbeat_s=0, call_timeout_s=0.5, first_call_timeout_s=5.0,
        )

    sc = scorer()

    def slow(locked):
        locked.set()  # "lock acquired": the timed portion starts here
        time.sleep(1.2)  # beyond call_timeout_s, inside first_call allowance
        return 42

    assert sc._with_watchdog(slow, ("score", 16, 32)) == 42  # cold: allowed
    assert sc._with_watchdog(lambda locked: 7, ("score", 16, 32)) == 7
    with pytest.raises(RuntimeError, match="did not complete"):
        sc._with_watchdog(slow, ("score", 16, 32))  # warm: steady timeout
    assert sc._closed  # watchdog expiry closes the scorer
    assert scorer()._with_watchdog(slow, ("masked", 16, 32, 64)) == 42


def test_watchdog_clock_excludes_lock_queueing(one_rank, small_q):
    """Time queued behind another in-flight call does not count toward the
    timeout; a call queued when the pod is declared dead fails fast with
    the 'queued' error."""
    sc = service.MultiHostScorer(
        small_q, fdt.EngineConfig(), one_rank, device="cpu",
        heartbeat_s=0, call_timeout_s=0.5, first_call_timeout_s=0.5,
    )
    gate = threading.Lock()  # stands in for a held _bcast_lock
    gate.acquire()

    def queued(locked):
        with gate:  # blocks ~3x call_timeout_s before "acquiring the lock"
            locked.set()
            return 11

    box = []
    t = threading.Thread(target=lambda: box.append(sc._with_watchdog(queued, ("score", 1, 1))))
    t.start()
    time.sleep(1.5)  # hold the gate well past call_timeout_s
    gate.release()
    t.join(10)
    assert not t.is_alive() and box == [11]  # queueing did not trip the watchdog

    gate.acquire()
    errs = []

    def call_into_closed():
        try:
            sc._with_watchdog(queued, ("score", 1, 1))
        except RuntimeError as e:
            errs.append(str(e))

    t2 = threading.Thread(target=call_into_closed)
    t2.start()
    time.sleep(0.3)
    sc._closed = True  # pod declared dead by the call holding the lock
    t2.join(10)
    gate.release()
    assert not t2.is_alive() and errs and "queued" in errs[0]


def test_heartbeat_hang_declares_pod_dead(one_rank, small_q, monkeypatch):
    """A beat hung while it holds _bcast_lock trips the same watchdog as
    scoring calls: the pod is declared dead and a call queued behind the
    held lock fails fast."""
    sc = service.MultiHostScorer(
        small_q, fdt.EngineConfig(), one_rank, device="cpu",
        heartbeat_s=0, call_timeout_s=0.3, first_call_timeout_s=0.5,
    )
    # one-process scorers skip the multi-process setup; graft what the
    # heartbeat needs so it can be driven directly
    sc._bcast_lock = threading.Lock()
    hang = threading.Event()
    monkeypatch.setattr(service, "_broadcast", lambda arr, group: hang.wait())

    hb = threading.Thread(target=sc._heartbeat, args=(0.05,), daemon=True)
    hb.start()
    deadline = time.monotonic() + 10
    while not sc._closed and time.monotonic() < deadline:
        time.sleep(0.05)
    assert sc._closed  # the hung beat tripped the watchdog

    def queued(locked):
        with sc._bcast_lock:
            locked.set()
            return 1

    with pytest.raises(RuntimeError, match="queued|closed"):
        sc._with_watchdog(queued, ("score", 1, 1))
    hang.set()  # release the abandoned broadcast thread
    hb.join(5)
    assert not hb.is_alive()


def test_heartbeat_survives_transient_broadcast_failure(one_rank, small_q, monkeypatch):
    """A transient beat failure with the scorer open is logged and the
    heartbeat keeps beating; it exits promptly once the scorer closes."""
    sc = service.MultiHostScorer(
        small_q, fdt.EngineConfig(), one_rank, device="cpu",
        heartbeat_s=0, call_timeout_s=5.0, first_call_timeout_s=5.0,
    )
    sc._bcast_lock = threading.Lock()  # graft the multi-process piece
    calls = []

    def flaky_broadcast(arr, group):
        calls.append(1)
        if len(calls) <= 2:
            raise RuntimeError("transient")

    monkeypatch.setattr(service, "_broadcast", flaky_broadcast)
    hb = threading.Thread(target=sc._heartbeat, args=(0.05,), daemon=True)
    hb.start()
    deadline = time.monotonic() + 10
    while len(calls) < 4 and time.monotonic() < deadline:
        time.sleep(0.05)
    assert len(calls) >= 4  # kept beating past the two failures
    assert not sc._closed
    sc._closed = True
    hb.join(5)
    assert not hb.is_alive()


def test_streaming_scorer_exported_from_the_root():
    from fastdnn_tpu_torch.engine.stream import StreamingScorer

    assert fdt.StreamingScorer is StreamingScorer and "StreamingScorer" in fdt.__all__


# -- the command lines ----------------------------------------------------------


@pytest.fixture(scope="module")
def files(j_q, inputs, tmp_path_factory):
    """A checkpoint of the net and a feature file."""
    work = tmp_path_factory.mktemp("cli")
    fd.save_qnet(j_q, work / "q.npz")
    fdt.write_features(inputs["frames"][:40], work / "f.bin")
    return work


def test_serve_parser_mesh_and_multi_process_flags(files):
    args = serve.build_parser().parse_args(
        ["m.npz", "--mesh-model", "2", "--mesh-data", "1", "--coordinator", "h:29500",
         "--num-processes", "2", "--process-id", "1", "--fast-posteriors"])
    assert (args.mesh_model, args.mesh_data, args.coordinator, args.num_processes,
            args.process_id, args.fast_posteriors) == (2, 1, "h:29500", 2, 1, True)
    assert serve._multi(args)
    assert serve._multi(serve.build_parser().parse_args(["m.npz", "--mesh-data", "2"]))
    assert args.input_precision == "high"
    # --input-precision reaches the EngineConfig, as tests/test_cli.py holds
    # the JAX CLI's flag to
    args = serve.build_parser().parse_args(
        [str(files / "q.npz"), "--device", "cpu", "--input-precision", "default",
         "--fast-posteriors"])
    scorer, _ = serve.build_scorer(args)
    assert scorer.config.input_precision == "default" and scorer.config.fast_posteriors is True


def test_serve_role_on_a_one_process_group(files, inputs, monkeypatch):
    """--coordinator with one process: the rank is 0, so it builds a
    MultiHostScorer coordinator and serves TCP; SIGTERM shuts it down,
    closes the scorer and leaves the process group."""
    built = {}
    make_server = serve.make_server

    def recording(args, prebuilt=None):
        built["server"] = make_server(args, prebuilt)
        built["scorer"] = prebuilt[0]
        return built["server"]

    monkeypatch.setattr(serve, "make_server", recording)
    got = {}

    def client():
        deadline = time.monotonic() + 60
        while signal.getsignal(signal.SIGTERM) is not serve._interrupt:
            if time.monotonic() > deadline:
                return
            time.sleep(0.05)
        c = serve.ScoreClient(*built["server"].server_address[:2])
        got["post"] = c.score(inputs["frames"][:5])
        c.close()
        os.kill(os.getpid(), signal.SIGTERM)

    t = threading.Thread(target=client, daemon=True)
    t.start()
    rc = serve.main([str(files / "q.npz"), "--device", "cpu", "--port", "0",
                     "--coordinator", f"127.0.0.1:{_free_port()}", "--num-processes", "1",
                     "--process-id", "0"])
    t.join(30)
    assert rc == 0 and not t.is_alive()
    sc = built["scorer"]
    assert isinstance(sc, service.MultiHostScorer) and sc.is_coordinator and sc._closed
    assert not dist.is_initialized()
    want = fdt.Scorer(fdt.load_qnet(files / "q.npz"), device="cpu").score(inputs["frames"][:5])
    _assert_close(got["post"], want)


def _env():
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("LOCAL_WORLD_SIZE", None)
    return env


def test_serve_over_two_processes(files, j_q, inputs):
    """`serve --mesh-model 2 --coordinator ... --process-id {0,1}` as two
    processes: rank 0 serves TCP, rank 1 prints its role and runs the
    worker loop; answers match one device; SIGTERM to rank 0 releases the
    worker and both exit 0."""
    coordinator = f"127.0.0.1:{_free_port()}"
    cmd = [sys.executable, "-m", "fastdnn_tpu_torch.cli.serve", str(files / "q.npz"),
           "--device", "cpu", "--port", "0", "--mesh-model", "2", "--coordinator",
           coordinator, "--num-processes", "2", "--process-id"]
    procs = [subprocess.Popen(cmd + [str(r)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, cwd=REPO, env=_env()) for r in range(2)]
    try:
        port = None
        lines = []
        for line in procs[0].stdout:
            lines.append(line)
            m = re.match(r"serving on [\d.]+:(\d+)", line)
            if m:
                port = int(m.group(1))
                break
        assert port is not None, "".join(lines)
        c = serve.ScoreClient("127.0.0.1", port)
        frames, masks = inputs["frames"][:17], inputs["masks"][:17]
        post, post_m = c.score(frames), c.score(frames, masks)
        c.close()
        procs[0].send_signal(signal.SIGTERM)
        outs = [p.communicate(timeout=60)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert [p.returncode for p in procs] == [0, 0], outs
    assert re.search(r"worker 1: Network = ", outs[1]), outs[1]
    single = _jax_scorer(j_q)
    _assert_close(post, single.score(frames))
    _assert_close(post_m, single.score_masked(frames, masks), MASKED_ATOL)


def test_score_iterations_and_refusals(files, inputs, capsys, tmp_path):
    out = tmp_path / "p.bin"
    assert score_cli.main([str(files / "q.npz"), str(files / "f.bin"), str(out), "BIN",
                           "--device", "cpu", "--iterations", "3"]) == 0
    assert re.search(r"Dnn calculation time = [\d.]+ ms\. \(cpu\)", capsys.readouterr().out)
    want = fdt.Scorer(fdt.load_qnet(files / "q.npz"), device="cpu").score(inputs["frames"][:40])
    np.testing.assert_array_equal(fdt.read_features(out), want)
    for extra in (["--text-input", "--iterations", "2"], ["--text-input", "--mask-density", "0.3"],
                  ["--iterations", "0"]):
        with pytest.raises(ValueError):
            score_cli.main([str(files / "q.npz"), str(files / "f.bin"), "--device", "cpu",
                            *extra])


def test_score_mesh_under_torchrun(files, inputs, tmp_path):
    """torchrun with two CPU ranks and --mesh-model 2: rank 0 alone writes
    the output, equal to one device within 1e-4."""
    out = tmp_path / "p.bin"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           "2", "-m", "fastdnn_tpu_torch.cli.score", str(files / "q.npz"),
           str(files / "f.bin"), str(out), "BIN", "--device", "cpu", "--mesh-model", "2",
           "--iterations", "2"]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=RANK_TIMEOUT_S,
                          cwd=REPO, env=_env())
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.count("Mesh        = data=1 x model=2") == 1  # rank 0 alone prints
    want = fdt.Scorer(fdt.load_qnet(files / "q.npz"), device="cpu").score(inputs["frames"][:40])
    _assert_close(fdt.read_features(out), want)

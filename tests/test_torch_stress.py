"""Concurrency stress tests of the port, after tests/test_stress.py, on
seeded synthetic frames (the JAX package's versions read the bundled
reference features).

One shared Scorer, many threads, random prefixes: every thread's result
must equal the serial result for its input, bitwise on the CPU.  The
Scorer's shared state is the launch counters (locked), the one-time kernel
build (locked) and the tensor-map cache of the kernels (locked); a call
allocates everything else it touches.
"""

import concurrent.futures
import sys
import threading

import numpy as np
import pytest
import torch

import fastdnn_tpu_torch as fdt
from fastdnn_tpu_torch.engine.stream import StreamingScorer
from fastdnn_tpu_torch.ops import kernels
from fastdnn_tpu_torch.ops import matmul as plain

FEATURE_FRAMES = 389  # the reference's aligned 8 kHz feature file


@pytest.fixture(scope="module")
def qnet():
    return fdt.quantize_net(fdt.random_net(np.random.default_rng(11), 432, [128, 128], 200))


@pytest.fixture(scope="module")
def features():
    return np.random.default_rng(8).standard_normal((FEATURE_FRAMES, 432), dtype=np.float32)


def _tasks(features, count, seed=1):
    """Shuffled random-length prefixes of the feature frames, as the
    reference's MultiThreadedStressTest draws them."""
    rng = np.random.default_rng(seed)
    tasks = []
    for _ in range(count):
        n = int(rng.integers(1, features.shape[0] + 1))
        tasks.append(features[rng.permutation(features.shape[0])[:n]])
    return tasks


def _shared_scorer_run(scorer, features, count):
    tasks = _tasks(features, count)
    serial = [scorer.score(t) for t in tasks]
    with concurrent.futures.ThreadPoolExecutor(max_workers=8) as ex:
        results = list(ex.map(scorer.score, tasks))
    for task, got, want in zip(tasks, results, serial):
        assert got.shape == (task.shape[0], scorer.output_dim)
        np.testing.assert_array_equal(got, want)


def _lazy_contexts_run(scorer, features, rng, exact=True):
    masks = (rng.random((4, 6, scorer.output_dim)) < 0.4).astype(np.uint8)

    def run(t):
        ctx = scorer.new_lazy_context(6)
        ctx.calculate_until_output(features[t:t + 6])
        return [ctx.calculate_for_output_nodes(masks[t][i]) for i in range(6)]

    serial = [run(t) for t in range(4)]
    with concurrent.futures.ThreadPoolExecutor(max_workers=4) as ex:
        results = list(ex.map(run, range(4)))
    for t in range(4):
        whole = scorer.score_masked(features[t:t + 6], masks[t])
        for i in range(6):
            if exact:
                np.testing.assert_array_equal(results[t][i], serial[t][i])
            else:
                assert np.abs(results[t][i] - serial[t][i]).max() <= 3e-5
            np.testing.assert_allclose(results[t][i], whole[i], atol=2e-6)


def _utterances_run(scorer, features):
    utts = {"a": features[:33], "b": features[100:107], "c": features[40:41]}
    batched = scorer.score_utterances(utts)
    assert set(batched) == {"a", "b", "c"}
    for k, frames in utts.items():
        np.testing.assert_array_equal(batched[k], scorer.score(frames))
    as_list = scorer.score_utterances([features[:5], features[5:9]])
    np.testing.assert_array_equal(as_list[0], scorer.score(features[:5]))
    np.testing.assert_array_equal(as_list[1], scorer.score(features[5:9]))
    assert scorer.score_utterances({}) == {}
    assert scorer.score_utterances([]) == []


def test_shared_scorer_multithreaded(qnet, features):
    """8 threads x 25 tasks, shuffled prefixes, bitwise agreement with the
    serial results."""
    _shared_scorer_run(fdt.Scorer(qnet, device="cpu"), features, 25 * 8)


def test_concurrent_lazy_contexts(qnet, features, rng):
    """Independent LazyContexts over one shared Scorer: bitwise the serial
    contexts' posteriors, and within 2e-6 of whole-utterance score_masked."""
    _lazy_contexts_run(fdt.Scorer(qnet, device="cpu"), features, rng)


def test_score_utterances_batch(qnet, features):
    _utterances_run(fdt.Scorer(qnet, device="cpu"), features)


def test_shape_fuzz(qnet, rng):
    """Random frame counts and feature dims (<= input dim) never crash and
    always give normalized posteriors."""
    scorer = fdt.Scorer(qnet, device="cpu")
    for _ in range(20):
        n = int(rng.integers(1, 300))
        d = int(rng.integers(1, scorer.input_dim + 1))
        out = scorer.score(rng.standard_normal((n, d)).astype(np.float32))
        assert out.shape == (n, scorer.output_dim)
        np.testing.assert_allclose(out.sum(-1), 1.0, rtol=1e-4)


def test_stream_submitters_under_fast_thread_switching(qnet, features):
    """More submitter threads than cores with a short switch interval: every
    frame is counted once, every result equals the serial one, and no
    thread is left behind."""
    scorer = fdt.Scorer(qnet, device="cpu")
    tasks = _tasks(features, 48, seed=5)
    results: list = [None] * len(tasks)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with StreamingScorer(scorer, max_batch_frames=2048, max_wait_ms=2.0) as ss:
            def worker(t):
                for i in range(t, len(tasks), 16):
                    results[i] = ss.submit(tasks[i]).result(120)

            threads = [threading.Thread(target=worker, args=(t,)) for t in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(180)
            assert not any(t.is_alive() for t in threads)
            frames = ss.throughput.frames
    finally:
        sys.setswitchinterval(old)
    assert frames == sum(t.shape[0] for t in tasks)
    for task, got in zip(tasks, results):
        np.testing.assert_array_equal(got, scorer.score(task))


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs the same checks on the card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_shared_scorer_multithreaded_on_card(qnet, features, cuda_device):
    _shared_scorer_run(fdt.Scorer(qnet, device=cuda_device), features, 25 * 8)


@pytest.mark.cuda
def test_concurrent_lazy_contexts_on_card(qnet, features, rng, cuda_device):
    _lazy_contexts_run(fdt.Scorer(qnet, device=cuda_device), features, rng, exact=False)


@pytest.mark.cuda
def test_score_utterances_batch_on_card(qnet, features, cuda_device):
    _utterances_run(fdt.Scorer(qnet, device=cuda_device), features)


@pytest.mark.cuda
def test_bias_sigmoid_odd_width_and_misaligned_view_on_card(cuda_device):
    """K1 at an N that is not a multiple of 16 (every row after the first
    off a 16-byte boundary) and on a slice of a larger buffer whose base is
    4 bytes past one: bitwise its plain version."""
    rng = np.random.default_rng(3)
    buf = torch.from_numpy(rng.uniform(-8, 8, 3 * 5127 + 1).astype(np.float32)).to(cuda_device)
    bias = torch.from_numpy(rng.standard_normal(5127).astype(np.float32)).to(cuda_device)
    for lin in (buf[:3 * 5127].view(3, 5127), buf[1:].view(3, 5127)):
        assert torch.equal(kernels.bias_sigmoid_i8(lin, bias), plain.bias_sigmoid_i8(lin, bias))

"""The stats route's yardsticks (benchmark/stats_route.py) and its four
readers: K8's and the normalize's roofline shares and the host time of the
program's `fastdnn.output_stats` and `fastdnn.trunk_layers` spans, on the
youtube configuration, against values worked out by hand; each reads
nothing without a trace."""

import json

import pytest

from benchmark import spec, stats_route, timeline
from benchmark.record import Run

MS = 1e-3
READERS = ("output_stats_roofline", "normalize_roofline", "output_stats.host_ms_per_request",
           "trunk_layers.host_ms_per_request")
YOUTUBE = json.loads((spec.HERE / "configs" / "youtube.json").read_text())
# K = 2560, N = 17,552, n = 8192: K8's operations 2 n K N; its bytes the
# activations n K, the weight K N, the zero-point sums and biases 8 N, z
# 4 n N and the row stats 8 n; the normalize's z 4 n N read, the posteriors
# 4 n N written, the row stats 8 n
K8_OPS = 2 * 8192 * 2560 * 17552  # 736.18 G
K8_BYTES = 20_971_520 + 44_933_120 + 140_416 + 575_143_936 + 65_536  # 641.25 MB
NORMALIZE_BYTES = 2 * 575_143_936 + 65_536  # 1.150 GB
K8_BOUND_S = K8_OPS / 1979e12  # 0.3720 ms: bound by operations (bytes 0.1914 ms)
NORMALIZE_BOUND_S = NORMALIZE_BYTES / 3.35e12  # 0.3434 ms: bound by bytes


def test_the_yardsticks_equal_the_hand_counts():
    k8 = stats_route.flash_stats(YOUTUBE, 8192)
    assert (k8.ops, k8.bytes, k8.precision) == (K8_OPS, K8_BYTES, "int8")
    assert K8_OPS == pytest.approx(736.18e9, rel=1e-5)
    assert k8.bound_s == pytest.approx(K8_BOUND_S) and k8.bound_s == k8.peak_s
    norm = stats_route.normalize(YOUTUBE, 8192)
    assert (norm.ops, norm.bytes) == (0.0, NORMALIZE_BYTES)
    assert norm.bound_s == pytest.approx(NORMALIZE_BOUND_S)
    assert NORMALIZE_BOUND_S == pytest.approx(0.3434e-3, rel=1e-3)


#: one dense request's operations, in ms from its start: K9, three K2, K8
#: after a gap, its normalize, and a skipping K8 that neither reader counts
DEVICE = [(0.08, 0.12, "void input_layer_kernel<1>(...)"),
          (0.12, 0.16, "void fdn::streamed_layer_kernel<fdn::SigmoidEpilogue>(...)"),
          (0.20, 0.24, "void fdn::streamed_layer_kernel<fdn::SigmoidEpilogue>(...)"),
          (0.24, 0.27, "void fdn::streamed_layer_kernel<fdn::SigmoidEpilogue>(...)"),
          (0.30, 1.044, "void fdn::flash_stats_kernel<false, false, false>(...)"),
          (1.044, 1.72, "void normalize_stats_kernel<false, 4>(...)"),
          (1.80, 1.85, "void fdn::flash_stats_kernel<true, false, true>(...)")]
HOST = [(0.05, 0.45, "fastdnn.score_device"), (0.10, 0.25, "fastdnn.trunk_layers"),
        (0.26, 0.42, "fastdnn.output_stats")]


def _run(requests=2, host=HOST, device=DEVICE):
    """`requests` dense requests of 8192 frames, 2 ms apart."""
    counts = {"frames": 8192, "hidden_frames": 8192, "output_frames": 8192}
    at = lambda spans, o: [((o + s) * MS, (o + e) * MS, x) for s, e, x in spans]
    reqs = [(2.0 * r * MS, 2.0 * (r + 1) * MS, counts) for r in range(requests)]
    tl = timeline.Timeline(
        window=(0.0, 2.0 * requests * MS), requests=reqs,
        device=sorted(sum((at(device, 2.0 * r) for r in range(requests)), [])),
        host=[(s, e, timeline.REQUEST_SPAN) for s, e, _ in reqs]
        + sum((at(host, 2.0 * r) for r in range(requests)), []),
    )
    return Run({"name": "youtube-dense"}, YOUTUBE, {}, 1.0, [], tl)


def _read(name, run):
    return spec.reader(name).read(run)


def test_readers_on_a_synthetic_trace():
    r = _run()
    # K8 0.744 ms a request for 0.3720 ms of work; the normalize 0.676 ms
    # for 0.3434 ms; the skipping K8 in neither
    assert _read("output_stats_roofline", r) == pytest.approx(100 * K8_BOUND_S / 0.744e-3)
    assert _read("normalize_roofline", r) == pytest.approx(100 * NORMALIZE_BOUND_S / 0.676e-3)
    # trunk_layers [0.10, 0.25]: 0.15 ms, the device busy in it K9's 0.02,
    # the K2s' 0.04, 0.04 and 0.01 -> 0.04 ms; output_stats [0.26, 0.42]:
    # 0.16 ms, busy the last K2's 0.01 and K8's first 0.12 -> 0.03 ms
    assert _read("trunk_layers.host_ms_per_request", r) == pytest.approx(0.04)
    assert _read("output_stats.host_ms_per_request", r) == pytest.approx(0.03)
    # the layer's own reader counts the work once over all three stats kernels
    both = 0.744 + 0.676 + 0.05
    share = _read("output_dense_roofline", r)
    assert share == pytest.approx(100 * max(
        2 * 8192 * 2560 * 17552 / 1979e12,
        (8192 * 2560 + 2560 * 17552 + 8 * 17552 + 4 * 8192 * 17552) / 3.35e12) / (both * MS))


def test_a_program_without_the_spans_reads_no_span_metric():
    r = _run(host=[h for h in HOST if h[2] == "fastdnn.score_device"])
    assert _read("trunk_layers.host_ms_per_request", r) is None
    assert _read("output_stats.host_ms_per_request", r) is None
    assert _read("output_stats_roofline", r) is not None  # the device trace still names K8


def test_a_run_without_the_stats_kernels_reads_no_roofline():
    r = _run(device=[d for d in DEVICE if "flash_stats" not in d[2] and "normalize" not in d[2]])
    assert _read("output_stats_roofline", r) is None
    assert _read("normalize_roofline", r) is None


@pytest.mark.parametrize("name", READERS)
def test_every_reader_reads_none_without_a_trace(name):
    assert _read(name, Run({"name": "youtube-dense"}, YOUTUBE, {}, 1.0, [], None)) is None

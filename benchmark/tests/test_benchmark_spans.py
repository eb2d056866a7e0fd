"""The readers of the program's spans (benchmark/spans.py) on synthetic
traces, against values worked out by hand; and on a trace of a program
that records no span, where each reads nothing."""

import pytest

from benchmark import spec, timeline
from benchmark.record import Run

MS = 1e-3
SPAN_READERS = (
    "dispatch.host_ms_per_request",
    "entry.idle_in_program_ms_per_request",
    "entry.idle_in_program_pct.lazy",
    "entry.masks_ms_per_request.lazy",
    "output_lazy.host_ms_per_request.lazy",
    "entry.finish_host_ms_per_request.lazy",
)


def _run(requests, device, host):
    """A Run whose timeline holds the requests' spans, the device's
    operations and the host's, given in ms."""
    ms = lambda spans: [(s * MS, e * MS, x) for s, e, x in spans]
    tl = timeline.Timeline(
        window=(requests[0][0] * MS, requests[-1][1] * MS),
        requests=ms(requests), device=ms(device),
        host=ms([(s, e, timeline.REQUEST_SPAN) for s, e, _ in requests] + host),
    )
    return Run({"name": "x"}, {}, {}, 1.0, [], tl)


def _dense():
    """Two device batches: each a score_device span that launches K9, K3
    and K4, then the caller's wait."""
    return _run(
        requests=[(0.0, 1.0, {}), (1.0, 2.0, {})],
        device=[(0.25, 0.35, "input_layer_kernel"), (0.35, 0.6, "hidden_stack_wgmma_kernel"),
                (0.6, 0.9, "resident_softmax_wgmma_kernel"),
                (1.15, 1.3, "input_layer_kernel"), (1.3, 1.5, "hidden_stack_wgmma_kernel"),
                (1.5, 1.9, "resident_softmax_wgmma_kernel")],
        host=[(0.1, 0.3, "fastdnn.score_device"), (1.05, 1.2, "fastdnn.score_device")],
    )


def _lazy():
    """Two lazy frames: each a frame span holding its masks, output_lazy
    and finish stages, with an upload, K5, a softmax op and a download."""
    return _run(
        requests=[(0.0, 0.5, {}), (0.5, 1.0, {})],
        device=[(0.11, 0.12, "Memcpy HtoD"), (0.20, 0.24, "output_logits_kernel"),
                (0.26, 0.33, "reduce_kernel"), (0.36, 0.38, "Memcpy DtoH"),
                (0.70, 0.72, "output_logits_kernel"), (0.75, 0.78, "reduce_kernel"),
                (0.90, 0.95, "Memcpy DtoH")],
        host=[(0.05, 0.45, "fastdnn.lazy.frame"), (0.06, 0.12, "fastdnn.masks"),
              (0.13, 0.30, "fastdnn.output_lazy"), (0.31, 0.44, "fastdnn.finish"),
              (0.52, 0.98, "fastdnn.lazy.frame"), (0.53, 0.60, "fastdnn.masks"),
              (0.61, 0.80, "fastdnn.output_lazy"), (0.81, 0.97, "fastdnn.finish")],
    )


def _read(name, run):
    return spec.reader(name).read(run)


def test_dense_readings():
    r = _dense()
    # the score_device spans: 0.2 and 0.15 ms over two requests
    assert _read("dispatch.host_ms_per_request", r) == pytest.approx((0.2 + 0.15) / 2)
    # idle: [0, 0.25], [0.9, 1.15], [1.9, 2.0] = 0.6 ms; inside the entry
    # spans: [0.1, 0.25] and [1.05, 1.15] = 0.25 ms over two requests
    assert _read("entry.idle_in_program_ms_per_request", r) == pytest.approx(0.25 / 2)
    assert _read("entry.idle_in_program_pct.lazy", r) == pytest.approx(100 * 0.25 / 0.6)


def test_lazy_readings():
    r = _lazy()
    # each stage's time less the device busy in it: the upload's 0.01 ms
    # in the first masks span; K5's and the softmax op's 0.04 + 0.04 and
    # 0.02 + 0.03 ms in the output_lazy spans
    assert _read("entry.masks_ms_per_request.lazy", r) == pytest.approx((0.06 + 0.07 - 0.01) / 2)
    want = (0.17 + 0.19 - (0.04 + 0.04 + 0.02 + 0.03)) / 2
    assert _read("output_lazy.host_ms_per_request.lazy", r) == pytest.approx(want)
    # finish: 0.13 + 0.16 ms, less the device busy in it: the softmax op's
    # [0.31, 0.33] and the downloads' 0.02 and 0.05 ms
    want = (0.13 + 0.16 - (0.02 + 0.02 + 0.05)) / 2
    assert _read("entry.finish_host_ms_per_request.lazy", r) == pytest.approx(want)
    # busy 0.24 ms of the 1-ms window, all of it inside the frames' spans
    # (0.40 + 0.46 ms): 0.62 of the 0.76 ms idle lies inside them
    want = 100 * (0.40 + 0.46 - 0.24) / (1.0 - 0.24)
    assert _read("entry.idle_in_program_pct.lazy", r) == pytest.approx(want)
    assert _read("entry.idle_in_program_ms_per_request", r) == pytest.approx(
        (0.40 + 0.46 - 0.24) / 2)


def test_the_idle_gaps_name_the_programs_spans():
    gaps = dict(timeline.breakdown(_lazy().timeline)["idle_gaps"])
    # every gap's midpoint lies inside a frame's span, most inside a stage's
    assert set(gaps) == {"fastdnn.lazy.frame", "fastdnn.masks", "fastdnn.output_lazy",
                         "fastdnn.finish"}
    assert sum(gaps.values()) == pytest.approx((1.0 - 0.24) * MS)


def test_spans_are_clipped_to_the_window():
    r = _lazy()
    # a span that starts before the window counts from the window's start
    r.timeline.host.append((-0.2 * MS, 0.02 * MS, "fastdnn.masks"))
    want = (0.06 + 0.07 - 0.01 + 0.02) / 2
    assert _read("entry.masks_ms_per_request.lazy", r) == pytest.approx(want)


@pytest.mark.parametrize("name", SPAN_READERS)
def test_a_program_without_spans_reads_nothing(name):
    for r in (_dense(), _lazy()):
        r.timeline.host = [h for h in r.timeline.host if not h[2].startswith("fastdnn.")]
        assert _read(name, r) is None
    assert _read(name, Run({"name": "x"}, {}, {}, 1.0, [], None)) is None

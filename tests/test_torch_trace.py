"""The program's spans (utils.timer.span, engine/scorer.py) on the CPU.

Under a torch.profiler every public entry records its span on the calling
thread, with its stages nested inside, read from the profiler's raw events
as the benchmark's timeline reads them (benchmark/timeline.py); every name
in engine.scorer.SPANS is recorded by some entry; with no profiler running a span
constructs nothing; and the posteriors are the same, bit for bit, with
and without a profiler running.  Three nets: two narrow ones (dense and
gathered lazy mode), whose trunk of one hidden-to-hidden layer runs the
per-layer loop, and one whose output layer is wider than the resident
softmax takes, so that its dense entries take the stats route.
"""

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

import fastdnn_tpu_torch as fdt
from fastdnn_tpu_torch.engine.scorer import SPANS, uses_resident_output
from fastdnn_tpu_torch.utils import timer

CALLER = "test.call"  # the caller's own span around each call, as the benchmark's
FRAMES, OUT = 70, 200  # 70 frames: not a multiple of the frame bucket
LAZY_FRAMES = 3

TRUNK = "fastdnn.trunk_layers"
STATS = "fastdnn.output_stats"
#: entry -> (its span, the stage spans nested in it)
ENTRIES = {
    "score": ("fastdnn.score", {TRUNK, "fastdnn.finish"}),
    "score_device": ("fastdnn.score_device", {TRUNK}),
    "score_masked": ("fastdnn.score_masked",
                     {"fastdnn.masks", TRUNK, "fastdnn.finish"}),
    "score_utterances": ("fastdnn.score", {TRUNK, "fastdnn.finish"}),
    "lazy.until_output": ("fastdnn.lazy.until_output", {TRUNK}),
    "lazy.frame": ("fastdnn.lazy.frame",
                   {"fastdnn.masks", "fastdnn.output_lazy", "fastdnn.finish"}),
}
#: the entries whose output layer runs the dense route, which on a net too
#: wide for the resident softmax records STATS
DENSE_OUTPUT = {"score", "score_device", "score_masked", "score_utterances"}
#: fixture -> (hidden widths, lazy mode): [128, 2176] feeds the output layer
#: a K past ops.kernels.RESIDENT_SOFTMAX_MAX_K
NETS = {"dense": ([128, 128], "dense"), "gathered": ([128, 128], "gathered"),
        "stats": ([128, 2176], "dense")}


@pytest.fixture(scope="module", params=list(NETS))
def scorer(request):
    hidden, lazy_mode = NETS[request.param]
    qnet = fdt.quantize_net(fdt.random_net(np.random.default_rng(18), 432, hidden, OUT))
    s = fdt.Scorer(qnet, fdt.EngineConfig(lazy_mode=lazy_mode), device="cpu")
    assert uses_resident_output(s.net) == (request.param != "stats")
    return s


def _stages(scorer, entry) -> set:
    """The stage spans `entry` records on this scorer's net."""
    stats = entry in DENSE_OUTPUT and not uses_resident_output(scorer.net)
    return ENTRIES[entry][1] | ({STATS} if stats else set())


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(5)
    frames = rng.standard_normal((FRAMES, 432), dtype=np.float32)
    # active senones among the first 100 only: the union stays within the
    # gathered mode's capacity (128 of 200)
    masks = ((rng.random((FRAMES, OUT)) < 0.4) & (np.arange(OUT) < 100)).astype(np.uint8)
    return frames, masks


def _call(scorer, entry, frames, masks, ctx=None):
    """One call of `entry`, its answer as numpy.  The lazy frame's context
    has been through calculate_until_output already."""
    if entry == "score":
        return scorer.score(frames)
    if entry == "score_device":
        batch = np.zeros((scorer.config.frame_bucket, 432), np.float32)
        batch[:FRAMES] = frames
        return scorer.score_device(torch.from_numpy(batch)).numpy()
    if entry == "score_masked":
        return scorer.score_masked(frames, masks)
    if entry == "score_utterances":
        return np.concatenate(scorer.score_utterances([frames[:30], frames[30:]]))
    if entry == "lazy.until_output":
        ctx = scorer.new_lazy_context(FRAMES)
        ctx.calculate_until_output(frames)
        return ctx._acts.numpy()
    return np.stack([ctx.calculate_for_output_nodes(m) for m in masks[:LAZY_FRAMES]])


def _traced(scorer, entry, frames, masks):
    """`entry` called inside the caller's span under a CPU profiler ->
    (its answer, the host events [(start_ns, end_ns, name, thread)])."""
    ctx = None
    if entry == "lazy.frame":
        ctx = scorer.new_lazy_context(FRAMES)
        ctx.calculate_until_output(frames)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(CALLER):
            out = _call(scorer, entry, frames, masks, ctx)
    events = [(ev.start_ns(), ev.start_ns() + ev.duration_ns(), ev.name(), ev.start_thread_id())
              for ev in prof.profiler.kineto_results.events()
              if ev.device_type() == DeviceType.CPU]
    return out, events


def _inside(inner, outer) -> bool:
    return outer[0] <= inner[0] and inner[1] <= outer[1]


@pytest.mark.parametrize("entry", list(ENTRIES))
def test_each_entry_records_its_span_with_its_stages_inside(scorer, inputs, entry):
    _, events = _traced(scorer, entry, *inputs)
    (caller,) = [e for e in events if e[2] == CALLER]
    mine = [e for e in events if e[2].startswith("fastdnn.")]
    assert {e[3] for e in mine} == {caller[3]}  # the calling thread
    assert all(_inside(e, caller) for e in mine)
    name, stages = ENTRIES[entry][0], _stages(scorer, entry)
    spans = [e for e in mine if e[2] == name]
    assert len(spans) == (LAZY_FRAMES if entry == "lazy.frame" else 1)
    assert {e[2] for e in mine} == {name} | stages
    for stage in (e for e in mine if e[2] in stages):
        assert any(_inside(stage, s) for s in spans), stage
    if entry == "lazy.frame":  # every frame runs each stage once, in order
        for s in spans:
            inner = sorted((e for e in mine if e[2] in stages and _inside(e, s)))
            assert [e[2] for e in inner] == ["fastdnn.masks", "fastdnn.output_lazy",
                                             "fastdnn.finish"]


def test_the_softmax_ops_fall_inside_output_lazy(scorer, inputs):
    _, events = _traced(scorer, "lazy.frame", *inputs)
    lazy = [e for e in events if e[2] == "fastdnn.output_lazy"]
    for op in ("aten::where", "aten::amax", "aten::exp"):
        found = [e for e in events if e[2] == op]
        assert found and all(any(_inside(e, s) for s in lazy) for e in found), op


def test_every_span_is_recorded_by_some_entry(scorer, inputs):
    names = set()
    for entry in ENTRIES:
        _, events = _traced(scorer, entry, *inputs)
        names |= {e[2] for e in events if e[2].startswith("fastdnn.")}
    # the stats net's entries record every span; a narrow net's all but the
    # stats route's; neither has a low-rank output layer's bottleneck nor a
    # TDNN-F net's output chain
    stats_route = not uses_resident_output(scorer.net)
    assert names == (set(SPANS) - (set() if stats_route else {STATS})
                     - {"fastdnn.output_bottleneck", "fastdnn.output_chain"})


def test_no_span_is_constructed_without_a_profiler(scorer, inputs, monkeypatch):
    def refuse(name):
        raise AssertionError(f"span {name!r} constructed with no profiler running")

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", refuse)
    assert timer.span("fastdnn.score") is timer.span("fastdnn.finish")
    frames, masks = inputs
    ctx = scorer.new_lazy_context(FRAMES)
    ctx.calculate_until_output(frames)
    for entry in ENTRIES:
        _call(scorer, entry, frames, masks, ctx)
    with profile(activities=[ProfilerActivity.CPU]):  # the constructor a span uses
        with pytest.raises(AssertionError, match="constructed"):
            timer.span("fastdnn.score")


@pytest.mark.parametrize("entry", list(ENTRIES))
def test_posteriors_are_bitwise_the_same_under_a_profiler(scorer, inputs, entry):
    frames, masks = inputs
    ctx = None
    if entry == "lazy.frame":
        ctx = scorer.new_lazy_context(FRAMES)
        ctx.calculate_until_output(frames)
    plain = _call(scorer, entry, frames, masks, ctx)
    traced, _ = _traced(scorer, entry, frames, masks)
    np.testing.assert_array_equal(traced, plain)

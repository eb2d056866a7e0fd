"""The route a net wider than the flagship takes, on the CPU, against the
benchmark's plain reference (benchmark/reference/net.py).

The YouTube configuration (benchmark/configs/youtube.json, 440 -> 4 x 2560
-> 17,552) is too wide for the one-launch trunk (H > HIDDEN_STACK_MAX_H)
and for the resident softmax (K > RESIDENT_SOFTMAX_MAX_K): its trunk runs
one layer kernel per layer and its output layer the stats kernel and the
normalize.  A 440 -> 3 x 2432 -> 1001 net takes the same two branches at a
size the CPU runs; 1001 senones, like 17,552, is not a multiple of the
output's 128-column tile.  The net is drawn, quantized and scored as the
benchmark does it (benchmark.model.draw, benchmark.program.build_scorer:
FeedForwardNet -> quantize_net -> Scorer, the default EngineConfig), and
score, score_device and LazyContext (both lazy semantics) are held to the
reference on the same float weights.

Tolerance: both sides take the input layer's product in float64 rounded
once to f32, the integer products exactly, and quantize alike, so every
sigmoid count and every logit agree bit for bit; the posteriors differ
only by the order of the softmax's f32 sums (the stats' running sum
against the reference's row sum): a few ulps an entry, well under 2e-6 of
L1 a row (here the plain versions read 0).  The reference with its input
layer's operands rounded to TF32 (input_rounding="tf32") flips sigmoid
counts, which carry through the trunk to every senone of the row: its
worst row lies about 6e-4 away, over a hundred times the tolerance.
"""

import json

import numpy as np
import pytest
import torch

from benchmark import generate, model, program, spec
from benchmark.reference.net import ReferenceNet
from fastdnn_tpu_torch.engine.scorer import uses_resident_output
from fastdnn_tpu_torch.ops import kernels

CONFIG = json.loads((spec.HERE / "configs" / "youtube.json").read_text())
SMALL = dict(CONFIG, hidden_widths=[2432, 2432, 2432], output_dim=1001)
FRAMES = 200
SEED = 2**33 + 20
#: the largest L1 distance of a posterior row from the reference's: the
#: softmax's f32 sums in another order (see the module's docstring)
ROW_L1 = 2e-6


@pytest.fixture(scope="module")
def net():
    return model.draw(SMALL, SEED, "cpu")


@pytest.fixture(scope="module")
def frames():
    return generate.features((FRAMES,), SEED, SMALL, "cpu")


@pytest.fixture(scope="module")
def masks():
    rng = generate.numpy_rng(SEED, "masks")
    return generate.generate_masks(rng, FRAMES, SMALL["output_dim"], 0.4)


def _scorer(net, semantics="reference"):
    config = dict(SMALL, engine={"lazy_semantics": semantics})
    return program.build_scorer(config, net, "cpu")


def _refs(net):
    """(the reference, the reference one precision below)."""
    return (ReferenceNet(net, SMALL["cutoff"], "cpu"),
            ReferenceNet(net, SMALL["cutoff"], "cpu", input_rounding="tf32"))


def _worst_row_l1(a, b) -> float:
    return float((torch.as_tensor(a).double() - torch.as_tensor(b).double()).abs().sum(1).max())


def _active_only(ref, frames, masks):
    """The reference's logits under the active_only semantics: a softmax
    over the active senones alone, 0 elsewhere and in a row with none."""
    z = ref.logits(ref.hidden(frames))
    active = torch.as_tensor(masks) != 0
    z = torch.where(active, z, -torch.inf)
    e = torch.exp(z - z.amax(dim=1, keepdim=True).clamp(min=-3e38))
    out = e / e.sum(dim=1, keepdim=True)
    return torch.where(active, out, 0.0)


def test_the_configuration_holds_the_published_widths():
    assert CONFIG["reduced"] == []
    assert (CONFIG["feature_dim"], CONFIG["input_dim"]) == (440, 440)
    assert CONFIG["hidden_widths"] == [2560] * 4 and CONFIG["output_dim"] == 17552
    assert (CONFIG["hidden_bits"], CONFIG["cutoff"], CONFIG["engine"]) == (8, 3.0, {})
    # both branches this file holds to the reference are the ones it forces
    assert max(CONFIG["hidden_widths"]) > kernels.HIDDEN_STACK_MAX_H
    assert CONFIG["hidden_widths"][-1] > kernels.RESIDENT_SOFTMAX_MAX_K


def test_the_net_takes_the_per_layer_trunk_and_the_stats_output(net):
    s = _scorer(net)
    assert s._hstack is None
    assert not uses_resident_output(s.net)


@pytest.mark.parametrize("entry", ["score", "score_device"])
def test_dense_posteriors_match_the_reference(net, frames, entry):
    s = _scorer(net)
    if entry == "score":
        out = s.score(frames.numpy())
    else:
        out = s.score_device(frames)
    assert out.shape == (FRAMES, SMALL["output_dim"])
    ref, ref_tf32 = _refs(net)
    want = ref.posteriors(frames)
    assert _worst_row_l1(out, want) <= ROW_L1
    assert _worst_row_l1(ref_tf32.posteriors(frames), want) > 100 * ROW_L1


@pytest.mark.parametrize("semantics", ["reference", "active_only"])
def test_lazy_context_matches_the_reference(net, frames, masks, semantics):
    s = _scorer(net, semantics)
    n = 24
    ctx = s.new_lazy_context(FRAMES)
    ctx.calculate_until_output(frames.numpy())
    out = np.stack([ctx.calculate_for_output_nodes(masks[t]) for t in range(n)])
    ref, ref_tf32 = _refs(net)
    if semantics == "reference":
        want = ref.masked_posteriors(frames[:n], torch.from_numpy(masks[:n]))
        low = ref_tf32.masked_posteriors(frames[:n], torch.from_numpy(masks[:n]))
    else:
        want = _active_only(ref, frames[:n], masks[:n])
        low = _active_only(ref_tf32, frames[:n], masks[:n])
    assert _worst_row_l1(out, want) <= ROW_L1
    assert _worst_row_l1(low, want) > 100 * ROW_L1

"""The benchmark's plain reference against the program's plain route on
the CPU, at a small size: the same float weights, quantized and scored by
each on its own, give the same posteriors."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from fastdnn_tpu_torch.ops import sigmoid as port_sigmoid
from fastdnn_tpu_torch.quant.quantize import quantize_layer

from benchmark import model
from benchmark.reference import compare
from benchmark.reference.net import ReferenceNet, quantize, quantized_sigmoid, sigmoid_table
from benchmark.spec import ROOT

SMALL = {"feature_dim": 429, "input_dim": 432, "hidden_widths": [256, 256, 256],
         "output_dim": 1000, "cutoff": 3.0, "hidden_bits": 8, "engine": {}}


def _port_scorer(net, config=SMALL):
    from benchmark.program import build_scorer

    return build_scorer(config, net, "cpu")


def test_sigmoid_table_equals_port_closed_form():
    x = torch.linspace(-7.0, 7.0, 200001, dtype=torch.float32)
    x = torch.cat([x, torch.tensor([5.125, -5.125, 6.395, 6.405, -6.395, -6.405, 0.005, -0.005])])
    ours = quantized_sigmoid(x, sigmoid_table("cpu")) - 128
    theirs = port_sigmoid.quantized_sigmoid_shifted_i8(x).to(torch.float64)
    assert torch.equal(ours, theirs)


@pytest.mark.parametrize("cutoff", [3.0, 0.05, 100.0])
def test_quantize_equals_port(cutoff):
    w = torch.randn(300, 200, generator=torch.Generator().manual_seed(3)) * 0.2
    w_q, inv = quantize(w, cutoff)
    port_q, mult = quantize_layer(w, cutoff)
    assert torch.equal(w_q, port_q.double())
    assert inv.item() == (1.0 / (mult * 255.0)).float().item()


@pytest.mark.parametrize("seed", [1, 2**33 + 5])
def test_reference_matches_port_plain_route(seed):
    net = model.draw(SMALL, seed, "cpu")
    frames = torch.randn(200, 429, generator=torch.Generator().manual_seed(seed % 1000))
    ref = ReferenceNet(net, SMALL["cutoff"], "cpu")
    ours = ref.posteriors(frames)
    theirs = torch.from_numpy(_port_scorer(net).score(frames.numpy()))
    assert float(compare.row_l1(theirs, ours).max()) < 1e-6


def test_masked_reference_matches_port_lazy_context():
    net = model.draw(SMALL, 7, "cpu")
    frames = np.random.default_rng(0).standard_normal((150, 429), dtype=np.float32)
    masks = (np.random.default_rng(1).random((150, 1000)) < 0.4).astype(np.uint8)
    masks[3] = 0  # a frame with no active senone: every logit 0, uniform
    ref = ReferenceNet(net, SMALL["cutoff"], "cpu")
    ours = ref.masked_posteriors(torch.from_numpy(frames), torch.from_numpy(masks))
    ctx = _port_scorer(net).new_lazy_context(150)
    ctx.calculate_until_output(frames)
    theirs = torch.from_numpy(np.stack([ctx.calculate_for_output_nodes(m) for m in masks]))
    assert float(compare.row_l1(theirs, ours).max()) < 1e-6
    assert torch.allclose(ours[3], torch.full((1000,), 1e-3))


def test_tf32_control_departs_from_reference():
    """The control (the reference one precision below) reads far above the
    program at a small size."""
    net = model.draw(SMALL, 11, "cpu")
    frames = torch.randn(512, 429, generator=torch.Generator().manual_seed(11))
    exact = ReferenceNet(net, SMALL["cutoff"], "cpu").posteriors(frames)
    low = ReferenceNet(net, SMALL["cutoff"], "cpu", input_rounding="tf32").posteriors(frames)
    program = torch.from_numpy(_port_scorer(net).score(frames.numpy()))
    assert compare.numbers([compare.row_l1(program, exact)])["worst_mean_row_l1"] < 1e-6
    assert compare.numbers([compare.row_l1(low, exact)])["worst_mean_row_l1"] > 1e-4


def test_compare_fails_nan_and_wrong_shapes():
    a = torch.full((4, 10), 0.1)
    assert compare.judge(compare.numbers([compare.row_l1(a, a)]), {"worst_mean_row_l1": 0.0})[0]
    nan = a.clone()
    nan[1, 1] = float("nan")
    ok, checks = compare.judge(compare.numbers([compare.row_l1(nan, a)]), {"worst_mean_row_l1": 1.0})
    assert not ok and checks["worst_mean_row_l1"]["value"] is None
    ok, _ = compare.judge(compare.numbers([compare.row_l1(a[:3], a)]), {"worst_mean_row_l1": 1.0})
    assert not ok


def test_reference_imports_nothing_of_the_program():
    code = ("import sys, benchmark.reference.net, benchmark.reference.compare; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'fastdnn_tpu_torch', 'fastdnn_tpu', 'jax', 'jaxlib', 'flax'}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=str(ROOT))
    assert out.stdout.strip() == "[]"


"""The Kaldi nnet1 feed-forward net: a float input layer, int8 sigmoid
hidden layers of `hidden_widths` and an int8 softmax output layer of
`output_dim` senones.  The net of every configuration that names none.
This module only binds the functions that draw, build, judge and count
it (spec.net lists the hooks)."""

from benchmark import model, program, roofline
from benchmark.reference.net import ReferenceNet

draw = model.draw
build = program.build_scorer
work = roofline.request_work
TINY = {"hidden_widths": [256, 256, 256], "output_dim": 1000}


def reference(config: dict, weights, device, input_rounding=None) -> ReferenceNet:
    return ReferenceNet(weights, config["cutoff"], device, input_rounding)

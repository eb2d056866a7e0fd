"""step_mfu: the dense passes' share of the card's peak in the traced
window, in %: the operations of every layer of every request, each at its
precision's peak, over the window."""

from benchmark.roofline import step_share


def read(run):
    return step_share(run, ("input_layer", "trunk", "output_dense"))

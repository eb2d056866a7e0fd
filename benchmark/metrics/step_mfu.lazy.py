"""step_mfu.lazy: the lazily scored frames' share of the card's peak in the
traced window, in %: each utterance's input layer and trunk, and each
frame's active senones, at their precisions' peaks, over the window."""

from benchmark.roofline import step_share


def read(run):
    return step_share(run, ("input_layer", "trunk", "output_lazy"))

"""chain_logits_roofline: the chain output's logits kernel (`chain_logits`)
roofline share in the traced window, in %: the least time of its own work,
the output rows' product and their f32 outputs (benchmark.tdnnf_route.
chain_logits), over its device time.  Nothing to read for a net without a
chain output, or where no such kernel ran."""

from benchmark.tdnnf_route import chain_logits, kernel_share


def read(run):
    if "prefinal_dim" not in run.config:
        return None
    return kernel_share(run, "chain_logits", chain_logits)

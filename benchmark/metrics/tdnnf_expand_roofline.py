"""tdnnf_expand_roofline: the factorized layers' affine kernel
(`tdnnf_expand`, the second kernel of a TDNN-F layer) roofline share in the
traced window, in %: the least time of its own work over the rows Kaldi's
compiler needs (benchmark.tdnnf_route.affine_kernel), over its device time.
Nothing to read for a net without factorized layers, or where no such
kernel ran."""

from benchmark.tdnnf_route import affine_kernel, kernel_share


def read(run):
    if "time_strides" not in run.config:
        return None
    return kernel_share(run, "tdnnf_expand", affine_kernel)

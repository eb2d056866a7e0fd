"""The yardsticks of two of the TDNN-F chain net's kernels alone, as
lowrank_route.py keeps the bottleneck's: the chain output's logits kernel
(`chain_logits`) and the factorized layers' affine kernel (`tdnnf_expand`),
so that chain_logits_roofline and tdnnf_expand_roofline show their shares
apart from their layers' (roofline.layer_share: output_dense and trunk).

Counted once, over the rows Kaldi's compiler needs (nets/tdnnf.py:
needed_rows), at the peaks of roofline.py, for a request's counters
(`chunks` of frames / chunks frames each):

  * chain_logits: 2 n P N int8 operations; p's codes [n, P] and scales, O
    int8 [P, N] and its f32 bias, the f32 outputs [n, N]; n = the output
    rows;
  * the affine kernels of every factorized layer: 2 n k H operations per
    time offset over its needed output rows n; its linear part's codes over
    the rows they are read at (k + 4 bytes a row), the E int8 [k, H] per
    offset, the bias, gamma and beta (12 H), the bypass rows read and the
    output rows written (H + 4 bytes each).
"""

from __future__ import annotations

from . import kernel_table
from . import spec as specs
from .roofline import Work


def chain_logits(config: dict, counts: dict) -> Work:
    p, n = config["prefinal_dim"], config["output_dim"]
    rows = counts["subsampled_rows"]
    return Work(2.0 * rows * p * n, rows * (p + 4.0) + p * n + 4.0 * n + 4.0 * rows * n, "int8")


def affine_kernel(config: dict, counts: dict) -> Work:
    h, k = config["hidden_dim"], config["bottleneck_dim"]
    chunks = counts["chunks"]
    need = specs.net(config).needed_rows(config, counts["frames"] // chunks)
    ops = byts = 0.0
    for s, rows, c_rows in need["layers"]:
        offsets = 1 if s == 0 else 2
        ops += chunks * offsets * 2.0 * rows * k * h
        byts += (chunks * (c_rows * (k + 4.0) + 2.0 * rows * (h + 4.0))
                 + offsets * k * h + 12.0 * h)
    return Work(ops, byts, "int8")


def kernel_share(run, kernel: str, work) -> float | None:
    """`kernel`'s roofline share in a traced run, in %: the least time of
    `work(config, counts)` of every request with chunks, over the device
    time of the kernels kernel_table names `kernel`, in the window.  None
    without a trace, such a request or such a kernel."""
    tl = run.timeline
    if tl is None:
        return None
    a, b = tl.window
    rows = [(sym, min(e, b) - max(s, a)) for s, e, sym in tl.device if e > a and s < b]
    device_s = kernel_table.by_kernel(rows)[0].get(kernel, 0.0)
    bound_s = sum(work(run.config, c).bound_s for _, _, c in tl.requests if c.get("chunks"))
    if device_s <= 0 or bound_s <= 0:
        return None
    return 100.0 * bound_s / device_s

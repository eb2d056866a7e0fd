"""The forward pass of a TDNN-F chain net (quant.quantize.QuantizedTdnnf).

A request is a batch of chunks, f32 [C, L + T + R, in] on the device, each
chunk T frames with the model's own left and right context (L = R = 39
rows for run_tdnn_1d; QuantizedTdnnf.context).  The answer is f32
[C, T / 3, N]: the chain output at t = 0, 3, ... of each chunk, no softmax.

The chunks are scored as one flat batch of rows, every layer one launch
over all of them, each time offset read as a row offset of the layer's
input (no spliced copy): tdnn1 (`tdnnf_input`), then per
factorized layer its linear and its affine kernels (K11, K12) inside the
span `fastdnn.trunk_layers`, then, inside `fastdnn.output_chain`,
prefinal-l (K11's chain variant), prefinal-chain's affine and linear (K12's
and K11's) and the chain output (K13): 5 + 2 x layers launches, 37 for
run_tdnn_1d.  The layer that reads every third row (QuantizedTdnnf.plan's
"drop") reads its input through a row map of stride 3, and prefinal-l reads
the outputs' rows of the last layer through another: every needed row is
computed, and rows near a chunk's edges that no output needs are computed
too (their reads may cross into the next chunk; no needed row reads them).

Frames are not independent, so a net with time context refuses at set-up
every entry and knob that rests on frame independence or has no route here
(check_time_context), on either backend.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import EngineConfig
from ..ops import kernels
from ..ops import matmul as xops
from ..quant.quantize import Matrix, QuantizedTdnnf
from ..utils.timer import span

IDENTITY = xops.ROWS_IDENTITY


def check_time_context(config: EngineConfig, mesh=None) -> None:
    """Raise ValueError, at set-up, for a net with time context under a knob
    it has no route for: a mesh, the int4 trunk, bf16 posteriors (it has
    no softmax), the gathered and block-sparse lazy modes, and the bf16
    input layer (tdnn1 sums its products in f64 at "high" and "highest"
    alike: one path, which the reference takes bit for bit)."""
    refused = {
        "a mesh": mesh is not None,
        "input_precision='default' (tdnn1 has one f64 path)": config.input_precision == "default",
        "int4_packed=True (a TDNN-F net has no int4 form)": config.int4_packed,
        "fast_posteriors=True": config.fast_posteriors,
        f"lazy_mode={config.lazy_mode!r}": config.lazy_mode in ("block_sparse", "gathered"),
    }
    bad = [name for name, on in refused.items() if on]
    if bad:
        raise ValueError(f"a net with time context (TDNN-F) runs on one device through "
                         f"score_device and score; refused: {', '.join(bad)}")


def refuse(entry: str):
    """The error an entry that rests on frame independence raises for a net
    with time context."""
    return ValueError(f"{entry} scores frames independently; a net with time context (TDNN-F) "
                      f"scores chunks with their context through score_device and score")


def kernel_layout(net: QuantizedTdnnf) -> QuantizedTdnnf:
    """The net with every matrix in the kernels' layout [out, in], each
    checked once here for the kernel that reads it
    (ops.kernels.check_tdnnf_input, check_tdnnf_matrix)."""
    t = lambda m: dataclasses.replace(m, weight=kernels.kernel_layout(m.weight))
    layers = tuple(dataclasses.replace(layer, linear=tuple(map(t, layer.linear)),
                                       affine=tuple(map(t, layer.affine)))
                   for layer in net.layers)
    net = dataclasses.replace(net, layers=layers, prefinal_l=t(net.prefinal_l),
                              prefinal_w=t(net.prefinal_w), prefinal_small=t(net.prefinal_small),
                              output=t(net.output), input_w=net.input_w.contiguous())
    check = kernels.check_tdnnf_matrix
    kernels.check_tdnnf_input(net.input_w, net.input_b, net.input_gamma, net.input_beta)
    for layer in net.layers:
        for m in layer.linear:
            check("tdnnf_project", m.weight, k_multiple=kernels.TILE_K,
                  n_exact=kernels.TDNNF_BOTTLENECK)
        for m in layer.affine:
            check("tdnnf_expand", m.weight, (layer.bias, layer.gamma, layer.beta), k_multiple=32,
                  n_multiple=kernels.TILE_N, max_k=kernels.TDNNF_MAX_AFFINE_K)
    check("chain_project", net.prefinal_l.weight, k_multiple=kernels.TILE_K,
          n_exact=kernels.CHAIN_WIDTH)
    check("chain_expand", net.prefinal_w.weight,
          (net.prefinal_b, net.prefinal_gamma, net.prefinal_beta), k_multiple=32,
          n_multiple=kernels.TILE_N, max_k=kernels.TDNNF_MAX_AFFINE_K)
    check("chain_project", net.prefinal_small.weight, (net.prefinal_small_b,),
          k_multiple=kernels.TILE_K, n_exact=kernels.CHAIN_WIDTH)
    check("chain_logits", net.output.weight, (net.output_b,), k_multiple=32, n_multiple=8,
          max_k=kernels.TDNNF_MAX_AFFINE_K)
    return net


def _term(codes, scale, m: Matrix, offset: int = 0) -> tuple:
    return (codes, scale, m.weight, m.inv_scale, offset)


@dataclasses.dataclass(frozen=True, eq=False)
class TdnnfRoute:
    """The pass of a net with time context on a backend (engine.backend)."""

    backend: object

    def score(self, net: QuantizedTdnnf, chunks: torch.Tensor) -> torch.Tensor:
        """chunks f32 [C, L + T + R, in] -> the chain output f32 [C, T / f, N]."""
        be = self.backend
        n_chunks, rows, _ = chunks.shape
        left, right = net.context()
        plan = net.plan(rows - left - right)
        f = net.subsampling
        codes, scale = be.tdnnf_input(net, chunks.reshape(n_chunks * rows, chunks.shape[2]))
        n, per_chunk, rate = n_chunks * rows, rows, 1
        with span("fastdnn.trunk_layers"):
            for i, layer in enumerate(net.layers):
                in_map, s_in = IDENTITY, layer.stride // rate
                if i == plan["drop"]:  # from here on every f-th row of a chunk
                    in_map = (plan["rows_low"], rows, plan["first"], f)
                    n, per_chunk, rate = n_chunks * plan["rows_low"], plan["rows_low"], f
                s_out = layer.stride // rate
                if layer.stride == 0:
                    linear = [_term(codes, scale, layer.linear[0])]
                else:
                    linear = [_term(codes, scale, layer.linear[0], -s_in),
                              _term(codes, scale, layer.linear[1])]
                c, c_scale = be.tdnnf_project(linear, n, in_map)
                affine = [_term(c, c_scale, m, o) for m, o in zip(layer.affine, (0, s_out))]
                codes, scale = be.tdnnf_expand(affine, n, IDENTITY, layer.bias, layer.gamma,
                                               layer.beta, (codes, scale, net.bypass_scale, in_map))
        outputs = n_chunks * plan["outputs"]
        if rate == 1:  # no layer subsampled: the outputs' rows of the full rate
            select = (plan["outputs"], per_chunk, left, f)
        else:
            select = (plan["outputs"], per_chunk, plan["out_first"], 1)
        with span("fastdnn.output_chain"):
            g, g_scale = be.tdnnf_project([_term(codes, scale, net.prefinal_l)], outputs, select,
                                          chain=True)
            v, v_scale = be.tdnnf_expand([_term(g, g_scale, net.prefinal_w)], outputs, IDENTITY,
                                         net.prefinal_b, net.prefinal_gamma, net.prefinal_beta,
                                         chain=True)
            p, p_scale = be.tdnnf_project([_term(v, v_scale, net.prefinal_small)], outputs,
                                          IDENTITY, net.prefinal_small_b, chain=True)
            y = be.chain_logits(p, p_scale, net.output.weight, net.output.inv_scale, net.output_b)
        return y.view(n_chunks, plan["outputs"], -1)

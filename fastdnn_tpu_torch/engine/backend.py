"""The two backends of the port behind one seam: the hand-written kernels
(ops/kernels.py, `KERNELS`) and their plain PyTorch versions (ops/matmul.py,
`PLAIN`), two instances of one class.

A backend owns three things:

  * the layout and the set-up of a net (`Backend.prepare`): padded to its
    lanes, int4 packed, sharded over a mesh's model axis, on the device and,
    for the kernels, transposed into their layout ([N, K], K contiguous:
    ops.kernels.kernel_layout) with the input kernel's operand;
  * the steps, under one set of names and signatures: the input layer, a
    hidden layer (packed or not, or low-rank), the hidden stack, a low-rank
    output layer's bottleneck, the output logits, the
    fused posteriors (resident, or the stats and the normalize; masked or
    not, block-sparse or not), the stats and the normalize a tensor-parallel
    output combines, and a few rows' masked posteriors from activations;
  * its name, "cuda" or "torch" (config.EngineConfig.resolve_backend), which
    only reports read.

The route (engine.scorer.Route) and the mesh programs (parallel.sharded)
hold a backend and call its steps; none of them asks which one it is.  The
kernel wrappers take CPU tensors too, through their plain versions, so the
kernels' backend runs its layout and its routes on the CPU as well.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..ops import kernels
from ..ops import matmul as xops
from ..quant.quantize import Bottleneck, QuantizedNet, QuantizedTdnnf, pack_int4_trunk, pad_qnet
from ..utils.timer import span
from .tdnnf import kernel_layout as tdnnf_kernel_layout


def output_layer(net: QuantizedNet) -> tuple:
    """(weight, colsum128, inv_scale, bias) of the output layer, as every
    output step takes them after the activations."""
    return (net.weights[-1], net.colsum128[-1], net.inv_scales[-1], net.biases[-1])


def uses_resident_output(net: QuantizedNet, *, block_sparse: bool = False) -> bool:
    """True when the fused output layer runs the resident softmax kernel
    (K4; K6 with block_sparse), False when it falls back to the stats kernel
    (K8) and a normalize pass, as the JAX package's gate of that name does.

    The JAX gate sizes the whole [K, N] weight and two working sets against
    the TPU's VMEM (48 MB, and a 100 MB clamp).  Those numbers are the
    TPU's: K4 never holds the weight, it keeps a 64-frame block of
    activations (64 K bytes) in shared memory beside its weight ring, so N
    does not enter and the limit is K <= ops.kernels.RESIDENT_SOFTMAX_MAX_K
    (K read from the previous layer's bias, the same in either layout).
    K6 is the same kernel with a list of its active tiles beside the ring,
    which fits at that K too, so `block_sparse` does not change the
    answer.  A low-rank output layer's K is its rank, the width of its
    bottleneck's codes."""
    bn = net.bottleneck(len(net.weights) - 1)
    if bn is not None:
        k = bn.colsum128.shape[0]
    else:
        k = (net.biases[-2] if len(net.biases) > 1 else net.input_b).shape[0]
    return k <= kernels.RESIDENT_SOFTMAX_MAX_K


def output_bottleneck(net: QuantizedNet):
    """(bottleneck, the expand factor's inv_scale) of a low-rank output
    layer, as the `bottleneck` step takes them; None for a dense one."""
    bn = net.bottleneck(len(net.weights) - 1)
    return None if bn is None else (bn, net.inv_scales[-1])


@dataclasses.dataclass(eq=False)
class Backend:
    """One way of running the route's steps.  The fields past the layout
    facts are the steps; each output step takes the activations, then the
    output layer (`output_layer`), and the kernels' steps read the weights
    in the kernels' layout, which `prepare` makes.  Not frozen, so that a
    test can substitute a step."""

    name: str
    #: node widths are padded to a multiple of this (pad_qnet's lanes)
    lanes: int
    #: the frames of the kernels' tile: a few rows are padded to it
    frame_tile: int
    #: its steps launch the hand-written kernels: block-sparse tile skipping
    #: and the launch-knob registry (tuning.py) exist only for them
    hand_written: bool
    #: (net on its device, input precision) -> the net its steps read
    lay_out: Callable
    #: (output weight, senone ids [C]) -> those senones' weight [K, C]
    senone_weights: Callable
    #: (net, frames f32 [B, in], input precision) -> shifted s8 [B, H]
    input_layer: Callable
    #: (acts, weight, colsum128, inv_scale, bias) -> acts
    hidden_layer: Callable
    hidden_layer_packed: Callable
    #: (acts, engine.scorer.build_hidden_stack's stack) -> acts
    hidden_stack: Callable
    #: (acts, Bottleneck, expand weight, colsum128, inv_scale, bias) -> acts
    lowrank_layer: Callable
    #: (acts, Bottleneck, the expand factor's inv_scale) -> (codes s8 [B, k], scale f32 [B])
    bottleneck: Callable
    #: (acts, *output layer) -> f32 logits [B, N]
    output_logits: Callable
    #: (acts, *output layer, masks, *, out_dim, semantics, fast, row_scale) -> [B, out_dim]
    resident_softmax: Callable
    #: (acts, *output layer, masks, *, out_dim, semantics) -> f32 [B, out_dim]
    resident_softmax_block_sparse: Callable
    #: (acts, *output layer, masks, *, valid_count, semantics, fast) -> (z, m, s[, tile_max])
    flash_stats: Callable
    #: (acts, *output layer, masks, *, valid_count, semantics, capped_fill) -> (z, m, s)
    flash_stats_block_sparse: Callable
    #: (z, m, s, *, out_dim, tile_max) -> [B, out_dim]
    normalize_stats: Callable
    #: (acts, *output layer, masks, *, out_dim, semantics, row_scale) -> f32 [rows, out_dim]
    lazy_output: Callable
    #: a TDNN-F net (engine.tdnnf): net on its device -> the net its steps read
    lay_out_tdnnf: Callable
    #: (net, rows f32 [n, in]) -> (codes s8 [n, H], scale f32 [n])
    tdnnf_input: Callable
    #: (terms, n_out, row map, bias=None, *, chain) -> (codes, scale); a term is
    #: (codes, scale, weight, inv_scale, row offset)
    tdnnf_project: Callable
    #: (terms, n_out, row map, bias, gamma, beta, bypass=None, *, chain) -> (codes, scale)
    tdnnf_expand: Callable
    #: (codes, scale, weight, inv_scale, bias) -> f32 [n, N]
    chain_logits: Callable

    def prepare(self, net: QuantizedNet, device, *, mesh=None, int4_packed: bool = False,
                input_precision: str = "high") -> QuantizedNet:
        """`net` as this backend's steps read it on `device`: every node
        width padded to the backend's lanes and the output's to 128 columns
        a model rank when a mesh splits it over more than one, the int4
        trunk packed (after the padding, so the halves split at the padded
        K) with `int4_packed`, this rank's output columns under `mesh`
        (parallel.mesh.shard_qnet), then laid out (`lay_out`).  The plain
        versions cut every output at the true senone count, so the plain
        backend pads nothing on one model rank.  The per-layer scales stay
        host scalars: the kernels take them by value."""
        model = 1
        if mesh is not None:
            from ..parallel.mesh import mesh_shape

            if net.has_lowrank:  # make_gspmd_scorer and score_shard_map come here unchecked
                raise ValueError("a net with low-rank layers runs on one device: refused: a mesh")
            model = mesh_shape(mesh)[1]
        out_lanes = kernels.TILE_N * model if model > 1 else self.lanes
        net = pad_qnet(net, lanes=self.lanes, out_lanes=out_lanes)
        if int4_packed:
            net = pack_int4_trunk(net)
        if mesh is not None:
            from ..parallel.mesh import shard_qnet

            net = shard_qnet(net, mesh)
        return self.lay_out(net.to(device), input_precision)

    def prepare_tdnnf(self, net: QuantizedTdnnf, device) -> QuantizedTdnnf:
        """A TDNN-F net as this backend's steps read it on `device`: no
        padding (its kernels take its widths as they are), then laid out
        (`lay_out_tdnnf`)."""
        return self.lay_out_tdnnf(net.to(device))

    def posteriors(self, net: QuantizedNet, acts: torch.Tensor, masks, *, out_dim: int,
                   semantics: str = "reference", fast: bool = False,
                   block_sparse: bool = False, row_scale=None) -> torch.Tensor:
        """Output layer + softmax -> [B, out_dim]: K4 (masks optional, bf16
        with `fast`), or K6 for masked block-sparse calls (f32 only), when
        the output layer fits them (uses_resident_output); otherwise one K8
        launch (skipping for block-sparse) and one normalize launch, inside
        the span `fastdnn.output_stats`.  Unlike the JAX package, no batch
        is cut into 8192-row chunks: that bounded a VMEM scratch of the TPU
        kernel, and K8 keeps its row stats in registers.  A low-rank output
        layer takes `acts` as its bottleneck's codes and `row_scale` their
        scales: K4's ROWSCALE variant (f32, never skipping)."""
        args = (acts, *output_layer(net))
        if row_scale is not None:
            return self.resident_softmax(*args, masks, out_dim=out_dim, semantics=semantics,
                                         row_scale=row_scale)
        if not uses_resident_output(net):
            with span("fastdnn.output_stats"):
                return self.stats_posteriors(*args, masks, out_dim=out_dim, semantics=semantics,
                                             fast=fast, block_sparse=block_sparse)
        if block_sparse and masks is not None:
            return self.resident_softmax_block_sparse(*args, masks, out_dim=out_dim,
                                                      semantics=semantics)
        return self.resident_softmax(*args, masks, out_dim=out_dim, semantics=semantics,
                                     fast=fast)

    def stats_posteriors(self, acts, w, colsum, inv_scale, bias, masks=None, *, out_dim: int,
                         semantics: str = "reference", fast: bool = False,
                         block_sparse: bool = False) -> torch.Tensor:
        """The stats route of `posteriors` at any K: one K8 launch, skipping
        all-inactive tiles for masked block-sparse calls (f32 only), then
        one normalize launch, exp(z - m) / s -> [B, out_dim]."""
        args = (acts, w, colsum, inv_scale, bias, masks)
        if block_sparse and masks is not None:
            z, m, s = self.flash_stats_block_sparse(*args, valid_count=out_dim,
                                                    semantics=semantics)
            return self.normalize_stats(z, m, s, out_dim=out_dim)
        stats = self.flash_stats(*args, valid_count=out_dim, semantics=semantics, fast=fast)
        return self.normalize_stats(*stats[:3], out_dim=out_dim,
                                    tile_max=stats[3] if fast else None)


def _kernel_layout(net: QuantizedNet, input_precision: str) -> QuantizedNet:
    """The net with its int8 weights in the kernels' layout (a packed int4
    layer [K/2, N] becomes [N, K/2]) and its input weight also as the input
    kernel's operand for `input_precision` (input_w stays as it is), checked
    once here for it (ops.kernels.check_input_layer).  The output layer is
    checked here for lazy_output, which takes it once a
    frame (ops.kernels.check_lazy_output_layer), and each low-rank layer's
    factors for K10 and the bottleneck (ops.kernels.check_lowrank_layer)."""
    operand = kernels.input_layer_operand(net.input_w, input_precision)
    kernels.check_input_layer(net.input_w, operand, net.input_b, input_precision)
    net = dataclasses.replace(
        net,
        weights=tuple(kernels.kernel_layout(w) for w in net.weights),
        input_operand=operand,
        bottlenecks=tuple(None if bn is None else dataclasses.replace(
            bn, weight=kernels.kernel_layout(bn.weight)) for bn in net.bottlenecks),
    )
    kernels.check_lazy_output_layer(net.weights[-1], net.colsum128[-1], net.biases[-1])
    last = len(net.weights) - 1
    for i, bn in enumerate(net.bottlenecks):
        if bn is not None:
            expand = (net.weights[i], net.biases[i]) if i < last else ()
            kernels.check_lowrank_layer(bn.weight, bn.colsum128, *expand)
    return net


def _kernels_input_layer(net: QuantizedNet, frames: torch.Tensor, precision: str):
    """K9 for "high" and "highest", its bf16 variant for "default"; the net
    carries the operand made for the same precision."""
    xops.check_input_precision(precision)
    layer = kernels.input_layer_bf16 if precision == "default" else kernels.input_layer
    return layer(frames, net.input_w, net.input_operand, net.input_b)


def _plain_lazy_output(acts, w, colsum, inv_scale, bias, masks, *, out_dim: int,
                       semantics: str = "reference", row_scale=None):
    """The logits, then the masked softmax of `semantics` in tensor ops."""
    logits = xops.output_logits(acts, w, colsum, inv_scale, bias, row_scale)[:, :out_dim]
    return xops.masked_softmax(logits, masks[:, :out_dim] != 0, semantics)


def _kernels_lowrank_layer(acts, bn: Bottleneck, w, colsum, inv_scale, bias):
    return kernels.lowrank_layer(acts, bn.weight, bn.colsum128, bn.inv_scale, w, colsum,
                                 inv_scale, bias)


def _plain_lowrank_layer(acts, bn: Bottleneck, w, colsum, inv_scale, bias):
    return xops.lowrank_layer_step(acts, bn.weight, bn.colsum128, bn.inv_scale, w, colsum,
                                   inv_scale, bias)


def _kernels_tdnnf_input(net: QuantizedTdnnf, rows: torch.Tensor):
    return kernels.tdnnf_input(rows, net.input_w, net.input_b, net.input_gamma, net.input_beta)


def _plain_project(terms, n_out, row_map, bias=None, *, chain=False):
    return xops.tdnnf_project_step(terms, n_out, row_map, bias)


def _plain_expand(terms, n_out, row_map, bias, gamma, beta, bypass=None, *, chain=False):
    return xops.tdnnf_expand_step(terms, n_out, row_map, bias, gamma, beta, bypass)


KERNELS = Backend(
    name="cuda",
    lanes=kernels.TILE_N,
    frame_tile=max(kernels.HIDDEN_LAYER_FRAMES, kernels.HIDDEN_STACK_FRAMES,
                   kernels.RESIDENT_SOFTMAX_FRAMES, kernels.OUTPUT_LOGITS_FRAMES,
                   kernels.FLASH_STATS_FRAMES),
    hand_written=True,
    lay_out=_kernel_layout,
    # [N, K]: a senone is a row
    senone_weights=lambda w, idx: w.index_select(0, idx).t(),
    input_layer=_kernels_input_layer,
    hidden_layer=kernels.hidden_layer,
    hidden_layer_packed=kernels.hidden_layer_packed,
    hidden_stack=lambda acts, hstack: kernels.hidden_stack(acts, *hstack),
    lowrank_layer=_kernels_lowrank_layer,
    bottleneck=lambda acts, bn, inv: kernels.lowrank_bottleneck(
        acts, bn.weight, bn.colsum128, bn.inv_scale, inv),
    output_logits=kernels.output_logits,
    resident_softmax=kernels.resident_softmax,
    resident_softmax_block_sparse=kernels.resident_softmax_block_sparse,
    flash_stats=kernels.flash_stats,
    flash_stats_block_sparse=kernels.flash_stats_block_sparse,
    normalize_stats=kernels.normalize_stats,
    lazy_output=kernels.lazy_output,
    lay_out_tdnnf=tdnnf_kernel_layout,
    tdnnf_input=_kernels_tdnnf_input,
    tdnnf_project=kernels.tdnnf_project,
    tdnnf_expand=kernels.tdnnf_expand,
    chain_logits=kernels.chain_logits,
)

PLAIN = Backend(
    name="torch",
    lanes=1,
    frame_tile=1,
    hand_written=False,
    lay_out=lambda net, input_precision: net,
    # [K, N]: a senone is a column
    senone_weights=lambda w, idx: w.index_select(1, idx),
    input_layer=lambda net, frames, precision: xops.input_layer_step(
        frames, net.input_w, net.input_b, precision),
    hidden_layer=xops.hidden_layer_step,
    hidden_layer_packed=xops.hidden_layer_step_packed,
    hidden_stack=xops.hidden_stack_step,
    lowrank_layer=_plain_lowrank_layer,
    bottleneck=lambda acts, bn, inv: xops.bottleneck_step(
        acts, bn.weight, bn.colsum128, bn.inv_scale, inv),
    output_logits=xops.output_logits,
    resident_softmax=xops.output_posteriors,
    resident_softmax_block_sparse=xops.output_posteriors_block_sparse,
    flash_stats=xops.flash_stats,
    flash_stats_block_sparse=xops.block_sparse_stats,
    normalize_stats=xops.normalize_stats,
    lazy_output=_plain_lazy_output,
    lay_out_tdnnf=lambda net: net,
    tdnnf_input=lambda net, rows: xops.tdnnf_input_step(
        rows, net.input_w, net.input_b, net.input_gamma, net.input_beta),
    tdnnf_project=_plain_project,
    tdnnf_expand=_plain_expand,
    chain_logits=xops.chain_logits_step,
)

BACKENDS = {b.name: b for b in (KERNELS, PLAIN)}


def get(name: str) -> Backend:
    """The backend of a name that config.EngineConfig.resolve_backend gives."""
    try:
        return BACKENDS[name]
    except KeyError:
        raise ValueError(f"unknown backend {name!r}: choose one of {', '.join(BACKENDS)}") from None

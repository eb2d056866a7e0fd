"""Sharded scoring: data-parallel frames x tensor-parallel output layer, on
torch.distributed.  The counterpart of fastdnn_tpu/parallel/sharded.py.

Three layers of API, all giving posteriors equal to one device:

  * `make_mesh_programs`, the production path behind
    `engine.Scorer(..., mesh=...)`: per-rank callables that run the
    configured kernels on the rank's rows and output columns, with the
    softmax collectives placed by hand over the model group;
  * `make_gspmd_scorer`, the JAX function's surface over those programs:
    the whole net and batch in on every rank, the whole posteriors out;
  * `score_shard_map`, the explicit-collective scorer over a whole net and
    batch (the logits kernel and the collective softmax), the same surface
    as the JAX function of that name.

Softmax over an output layer split by columns needs a global max and a
global sum.  With logits z split over the model ranks,

    m = all_reduce_max(max(z_local));  s = all_reduce_sum(sum(exp(z_local - m)))
    softmax = exp(z_local - m) / s

which is exact, not approximate.  With fused_softmax each rank's stats
kernel (K8) gives its local (z, m_l, s_l) in one pass, and the combine is
m = max over ranks of m_l, s = sum over ranks of s_l exp(m_l - m): two
all-reduces of one f32 per row.  Masked semantics compose the same way: the
reference's zero logit for an inactive senone is just another z.
"""

from __future__ import annotations

import weakref
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..config import EngineConfig
from ..engine.backend import get as get_backend
from ..engine.backend import output_layer
from ..engine.scorer import Route, build_hidden_stack, check_block_sparse
from ..ops import matmul as xops
from ..quant.quantize import QuantizedNet
from ..utils.align import aligned_size
from .mesh import (
    MODEL_AXIS,
    gather_blocks,
    local_cols,
    local_rows,
    mesh_coords,
    mesh_shape,
)


def _all_reduce(t: torch.Tensor, op, group) -> torch.Tensor:
    """In-place all-reduce of a per-row stat [B, 1] over `group`."""
    dist.all_reduce(t, op=op, group=group)
    return t


def _valid_count(n_local: int, out_dim: int, model_rank: int) -> int:
    """Real senone columns of a model rank's n_local-wide slice: the rest is
    padding, kept out of the softmax."""
    return min(max(out_dim - model_rank * n_local, 0), n_local)


def _valid_cols(n_local: int, out_dim: Optional[int], model_rank: int, device):
    """bool [1, n_local]: True where the column is a real senone; None when
    every column is (out_dim None)."""
    if out_dim is None:
        return None
    col = model_rank * n_local + torch.arange(n_local, device=device)
    return (col < out_dim)[None, :]


def _sharded_softmax(z_local: torch.Tensor, valid, group) -> torch.Tensor:
    """Exact softmax over an output axis split over the model group."""
    if valid is not None:
        z_local = torch.where(valid, z_local, xops.NEG_CAP)
    m = _all_reduce(z_local.amax(dim=-1, keepdim=True), dist.ReduceOp.MAX, group)
    e = torch.exp(z_local - m)
    if valid is not None:
        e = torch.where(valid, e, 0.0)
    s = _all_reduce(e.sum(dim=-1, keepdim=True), dist.ReduceOp.SUM, group)
    return e / s


def _sharded_posteriors_from_logits(z, masks, valid, semantics: str, group) -> torch.Tensor:
    """Masked or unmasked collective softmax over local logit columns.

    masks: local [B, n_local] (nonzero = active) or None.  Reference keeps
    zero logits for inactive senones in the denominator; active_only
    renormalizes over the active ones and gives an all-zero row for a frame
    with none."""
    if masks is None:
        return _sharded_softmax(z, valid, group)
    mask_bool = masks != 0
    if valid is not None:
        mask_bool = mask_bool & valid
    if semantics == "reference":
        return _sharded_softmax(torch.where(mask_bool, z, 0.0), valid, group)
    zm = torch.where(mask_bool, z, xops.NEG_CAP)
    m = _all_reduce(zm.amax(dim=-1, keepdim=True), dist.ReduceOp.MAX, group)
    e = torch.where(mask_bool, torch.exp(zm - m), 0.0)
    s = _all_reduce(e.sum(dim=-1, keepdim=True), dist.ReduceOp.SUM, group)
    return e / torch.clamp(s, min=torch.finfo(torch.float32).tiny)


def _sharded_fused_posteriors(route: Route, net: QuantizedNet, acts, masks, *,
                              model_rank: int, group) -> torch.Tensor:
    """Tensor-parallel fused softmax: each rank's stats kernel (K8, or its
    plain version) gives its local logits and unnormalized (max, sum-exp)
    in one pass; two all-reduces of one f32 per row make them global, and
    one normalize of the local logits finishes.  The rank's valid column
    count, clamp(out_dim - r n_local, 0, n_local), is a runtime argument of
    the kernel.

    block_sparse (masked calls): the skipping variant; its skipped tiles
    store -1e30 beyond the valid count (capped_fill), since the local block
    keeps its padded width, and under reference semantics each rank counts
    its own skipped real senones once, so the sum counts every inactive
    senone exactly once.  fast_posteriors narrows only the final
    posteriors to bf16; stats and normalize stay f32."""
    be = route.backend
    n_local = net.padded_output_dim
    valid = _valid_count(n_local, route.out_dim, model_rank)
    args = (acts, *output_layer(net), masks)
    if route.block_sparse and masks is not None:
        z, m_l, s_l = be.flash_stats_block_sparse(*args, valid_count=valid,
                                                  semantics=route.semantics, capped_fill=True)
    else:
        z, m_l, s_l = be.flash_stats(*args, valid_count=valid, semantics=route.semantics)
    m = _all_reduce(m_l.clone(), dist.ReduceOp.MAX, group)
    s = _all_reduce(s_l * torch.exp(m_l - m), dist.ReduceOp.SUM, group)
    # rows whose global max stayed at the cap (no active senone anywhere,
    # active_only) -> zeros
    p = be.normalize_stats(z, m, s, out_dim=n_local)
    return p.to(torch.bfloat16) if route.fast_posteriors else p


def _pad_rows(x: torch.Tensor, multiple: int) -> torch.Tensor:
    extra = -x.shape[0] % multiple
    return torch.nn.functional.pad(x, (0, 0, 0, extra)) if extra else x


def make_mesh_programs(mesh: DeviceMesh, route: Route):
    """Per-rank programs of a mesh-backed Scorer, each over this rank's net
    (the route's backend prepared it with the mesh) and this rank's rows:

      score(net, frames)                -> posteriors
      score_masked(net, frames, masks)  -> posteriors (masks: the rank's
                                           columns of the padded width)
      hidden(net, frames)               -> last-hidden int8 activations
      masked_from_acts(net, acts, masks)-> posteriors from stored activations

    With model = 1 a rank runs the route itself on its rows and gives
    [B_local, out_dim].  With model > 1 the output layer runs as the rank's
    stats kernel (fused_softmax) or logits kernel, plus the exact
    collective softmax, and gives [B_local, n_local]: the rank's columns of
    the padded width, padding columns 0.  Every rank of a model group must
    make the same calls.  The trunk keeps the one-launch stack kernel when
    the route has a stack: a torch rank can hold it, where JAX's shard_map
    could not capture it.
    """
    if route.block_sparse:
        check_block_sparse(route.backend, route.fused_softmax)
    _, model = mesh_shape(mesh)
    if model == 1:
        return route.score, route.score_masked, route.hidden, route.masked_from_acts
    model_rank = mesh_coords(mesh)[1]
    group = mesh.get_group(MODEL_AXIS)
    frame_tile = route.backend.frame_tile

    def out(net, acts, masks):
        if route.fused_softmax:
            return _sharded_fused_posteriors(route, net, acts, masks, model_rank=model_rank,
                                             group=group)
        z = route.backend.output_logits(acts, *output_layer(net))
        p = _sharded_posteriors_from_logits(
            z, masks, _valid_cols(z.shape[1], route.out_dim, model_rank, z.device),
            route.semantics, group)
        return p.to(torch.bfloat16) if route.fast_posteriors else p

    def score(net, frames):
        return out(net, route.hidden(net, frames), None)

    def score_masked(net, frames, masks):
        return out(net, route.hidden(net, frames), masks)

    def masked_from_acts(net, acts, masks):
        # a few stored rows (LazyContext): padded to the kernels' frame tile
        b = acts.shape[0]
        return out(net, _pad_rows(acts, frame_tile), _pad_rows(masks, frame_tile))[:b]

    return score, score_masked, route.hidden, masked_from_acts


def make_gspmd_scorer(mesh: DeviceMesh, *, out_dim: Optional[int] = None,
                      semantics: str = "reference", fused_softmax: bool = True,
                      fast_posteriors: bool = False, backend: str = "cuda",
                      input_precision: str = "high"):
    """(score, score_masked) over the mesh, the surface of the JAX function
    of that name:

      score(qnet, frames)               -> posteriors [B, out_dim]
      score_masked(qnet, frames, masks) -> posteriors [B, out_dim]

    Every rank passes the whole net (as quant.quantize_net gives it) and
    the whole batch: frames f32 [B, <= input dim] on the rank's device,
    masks [B, out] (nonzero = active), any B.  Each rank scores its rows
    and its output columns with `make_mesh_programs` and every rank gets
    the whole posteriors back on the frames' device, as the JAX function's
    out_sharding P(DATA_AXIS, None) gives them.  The JAX function jits
    through the partitioner; torch has none that sees through the
    hand-written kernels, so the collectives are make_mesh_programs' own.

    backend "cuda" runs the kernels on CUDA tensors (their plain versions
    on CPU tensors), "torch" the plain versions; `input_precision` picks
    the input layer's product (config.EngineConfig).  The rank's padded,
    sharded and prepared net and its programs are kept for the last net
    object passed: a repeat call with the same net moves no weights.
    JAX caches its executables per net structure instead; a prepared torch
    net holds the weights, so it is keyed on the net itself.
    """
    data, model = mesh_shape(mesh)
    xops.check_input_precision(input_precision)
    be = get_backend(backend)
    defaults = EngineConfig()
    rows_multiple = defaults.frame_bucket * data
    cached: list = [None]  # (weakref to the net, device, rank net, programs)

    def prepared(qnet: QuantizedNet, device):
        hit = cached[0]
        if hit is not None and hit[0]() is qnet and hit[1] == device:
            return hit[2], hit[3]
        net = be.prepare(qnet, device, mesh=mesh, input_precision=input_precision)
        programs = make_mesh_programs(mesh, Route(
            be, qnet.output_dim if out_dim is None else out_dim, fused_softmax=fused_softmax,
            fast_posteriors=fast_posteriors, hstack=build_hidden_stack(net),
            stack_max_frames=defaults.stack_hidden_max_frames, input_precision=input_precision,
            semantics=semantics))
        cached[0] = (weakref.ref(qnet), device, net, programs)
        return net, programs

    def run(qnet, frames, masks=None):
        net, programs = prepared(qnet, frames.device)
        b = frames.shape[0]
        rows = aligned_size(max(b, 1), rows_multiple)
        frames = torch.nn.functional.pad(
            frames.float(), (0, net.input_dim - frames.shape[1], 0, rows - b))
        with torch.inference_mode():
            if masks is None:
                p = programs[0](net, local_rows(frames, mesh))
            else:
                width = net.padded_output_dim * model
                masks = torch.nn.functional.pad(
                    masks.to(device=frames.device, dtype=torch.uint8),
                    (0, width - masks.shape[1], 0, rows - b))
                p = programs[1](net, local_rows(frames, mesh),
                                local_cols(local_rows(masks, mesh), mesh))
            n = qnet.output_dim if out_dim is None else out_dim
            return gather_blocks(p, mesh)[:b, :n].to(frames.device)

    def score(qnet, frames):
        return run(qnet, frames)

    def score_masked(qnet, frames, masks):
        return run(qnet, frames, masks)

    return score, score_masked


def score_shard_map(qnet: QuantizedNet, frames: torch.Tensor, mesh: DeviceMesh, *,
                    masks: Optional[torch.Tensor] = None, backend: str = "torch",
                    semantics: str = "reference", out_dim: Optional[int] = None,
                    input_precision: str = "high") -> torch.Tensor:
    """Explicit-collective scoring of a whole batch on every rank.

    qnet: the whole net in the JAX layout, its output width divisible by the
    model axis (pad_qnet(out_lanes=128 * model)); its true senone count
    keeps padding columns out of the softmax by default.  frames [B, in] on
    this rank's device, B divisible by the data axis (and by the kernels'
    64-frame tile on the CUDA backend); masks None or [B, N_padded].  Each
    rank scores its rows and columns with the logits kernel (K5) and the
    collective softmax; `input_precision` picks the input layer's product.
    Returns the posteriors [B, N_padded], gathered on every rank (columns
    at or beyond out_dim exactly 0), on the frames' device."""
    if out_dim is None:
        out_dim = qnet.output_dim
    model_rank = mesh_coords(mesh)[1]
    be = get_backend(backend)
    net = be.prepare(qnet, frames.device, mesh=mesh, input_precision=input_precision)
    acts = Route(be, out_dim, input_precision=input_precision).hidden(net, local_rows(frames, mesh))
    z = be.output_logits(acts, *output_layer(net))
    local_masks = None if masks is None else local_cols(local_rows(masks, mesh), mesh)
    p = _sharded_posteriors_from_logits(
        z, local_masks, _valid_cols(z.shape[1], out_dim, model_rank, z.device), semantics,
        mesh.get_group(MODEL_AXIS))
    return gather_blocks(p, mesh).to(frames.device)

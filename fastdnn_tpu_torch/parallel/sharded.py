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
from ..engine import cuda_backend
from ..engine.scorer import (
    build_hidden_stack,
    hidden_forward,
    masked_posteriors_from_acts,
    output_logits,
    score_fn,
    score_masked_fn,
)
from ..ops import kernels
from ..ops import matmul as xops
from ..quant.quantize import QuantizedNet, pad_qnet
from ..utils.align import aligned_size
from .mesh import (
    MODEL_AXIS,
    gather_blocks,
    local_cols,
    local_rows,
    mesh_coords,
    mesh_shape,
    shard_qnet,
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


def _sharded_fused_posteriors(net: QuantizedNet, acts, masks, *, out_dim: int, semantics: str,
                              backend: str, model_rank: int, group, block_sparse: bool = False,
                              fast: bool = False) -> torch.Tensor:
    """Tensor-parallel fused softmax: each rank's stats kernel (K8, or its
    plain version on backend "torch") gives its local logits and
    unnormalized (max, sum-exp) in one pass; two all-reduces of one f32 per
    row make them global, and one read of the local logits normalizes (one
    normalize launch on the CUDA backend).  The
    rank's valid column count, clamp(out_dim - r n_local, 0, n_local), is a
    runtime argument of the kernel.

    block_sparse (masked calls, CUDA backend): the skipping variant; its
    skipped tiles store -1e30 beyond the valid count (capped_fill), since
    the local block keeps its padded width, and under reference semantics
    each rank counts its own skipped real senones once, so the sum counts
    every inactive senone exactly once.  `fast` narrows only the final
    posteriors to bf16; stats and normalize stay f32."""
    n_local = net.biases[-1].shape[0]
    valid = _valid_count(n_local, out_dim, model_rank)
    args = (acts, net.weights[-1], net.colsum128[-1], net.inv_scales[-1], net.biases[-1], masks)
    if backend == "torch":
        if block_sparse and masks is not None:
            z, m_l, s_l = xops.block_sparse_stats(*args, valid_count=valid, semantics=semantics,
                                                  capped_fill=True)
        else:
            z, m_l, s_l = xops.flash_stats(*args, valid_count=valid, semantics=semantics)
    elif block_sparse and masks is not None:
        z, m_l, s_l = cuda_backend.output_flash_stats_block_sparse(
            *args, valid_count=valid, semantics=semantics)
    else:
        z, m_l, s_l = cuda_backend.output_flash_stats(*args, valid_count=valid,
                                                      semantics=semantics)
    m = _all_reduce(m_l.clone(), dist.ReduceOp.MAX, group)
    s = _all_reduce(s_l * torch.exp(m_l - m), dist.ReduceOp.SUM, group)
    # one read of the local logits (the normalize kernel on the CUDA
    # backend); rows whose global max stayed at the cap (no active senone
    # anywhere, active_only) -> zeros
    normalize = xops.normalize_stats if backend == "torch" else kernels.normalize_stats
    p = normalize(z, m, s, out_dim=n_local)
    return p.to(torch.bfloat16) if fast else p


def _pad_rows(x: torch.Tensor, multiple: int) -> torch.Tensor:
    extra = -x.shape[0] % multiple
    return torch.nn.functional.pad(x, (0, 0, 0, extra)) if extra else x


def make_mesh_programs(mesh: DeviceMesh, *, out_dim: int, backend: str,
                       semantics: str = "reference", fused_softmax: bool = True,
                       fast_posteriors: bool = False, block_sparse: bool = False,
                       hstack=None, stack_max_frames: int = 0):
    """Per-rank programs of a mesh-backed Scorer, each over this rank's net
    (mesh.shard_qnet, then on its device and, for the CUDA backend, in the
    kernels' layout) and this rank's rows:

      score(net, frames)                -> posteriors
      score_masked(net, frames, masks)  -> posteriors (masks: the rank's
                                           columns of the padded width)
      hidden(net, frames)               -> last-hidden int8 activations
      masked_from_acts(net, acts, masks)-> posteriors from stored activations

    With model = 1 a rank runs the whole single-device program on its rows
    and gives [B_local, out_dim].  With model > 1 the output layer runs as
    the rank's stats kernel (fused_softmax) or logits kernel, plus the exact
    collective softmax, and gives [B_local, n_local]: the rank's columns of
    the padded width, padding columns 0.  Every rank of a model group must
    make the same calls.  The trunk keeps the one-launch stack kernel when
    `hstack` is given: a torch rank can hold it, where JAX's shard_map could
    not capture it.
    """
    _, model = mesh_shape(mesh)
    model_rank = mesh_coords(mesh)[1]
    group = mesh.get_group(MODEL_AXIS)
    if block_sparse and not (backend == "cuda" and fused_softmax):
        raise ValueError(
            "block_sparse mesh programs need backend='cuda' with fused_softmax=True: "
            "the tile skipping lives inside the stats kernel"
        )
    frame_tile = kernels.FLASH_STATS_FRAMES if backend == "cuda" else 1

    def hidden(net, frames):
        return hidden_forward(net, frames, backend, hstack, stack_max_frames)

    if model == 1:
        def score(net, frames):
            return score_fn(net, frames, backend=backend, out_dim=out_dim,
                            fused_softmax=fused_softmax, fast_posteriors=fast_posteriors,
                            hstack=hstack, stack_max_frames=stack_max_frames)

        def score_masked(net, frames, masks):
            return score_masked_fn(net, frames, masks, backend=backend, semantics=semantics,
                                   out_dim=out_dim, fused_softmax=fused_softmax,
                                   fast_posteriors=fast_posteriors, hstack=hstack,
                                   stack_max_frames=stack_max_frames, block_sparse=block_sparse)

        def masked_from_acts(net, acts, masks):
            return masked_posteriors_from_acts(net, acts, masks, backend=backend,
                                               semantics=semantics, out_dim=out_dim)

        return score, score_masked, hidden, masked_from_acts

    def out(net, acts, masks):
        if fused_softmax:
            return _sharded_fused_posteriors(
                net, acts, masks, out_dim=out_dim, semantics=semantics, backend=backend,
                model_rank=model_rank, group=group, block_sparse=block_sparse,
                fast=fast_posteriors)
        z = output_logits(net, acts, backend)
        p = _sharded_posteriors_from_logits(
            z, masks, _valid_cols(z.shape[1], out_dim, model_rank, z.device), semantics, group)
        return p.to(torch.bfloat16) if fast_posteriors else p

    def score(net, frames):
        return out(net, hidden(net, frames), None)

    def score_masked(net, frames, masks):
        return out(net, hidden(net, frames), masks)

    def masked_from_acts(net, acts, masks):
        # a few stored rows (LazyContext): padded to the kernels' frame tile
        b = acts.shape[0]
        return out(net, _pad_rows(acts, frame_tile), _pad_rows(masks, frame_tile))[:b]

    return score, score_masked, hidden, masked_from_acts


def make_gspmd_scorer(mesh: DeviceMesh, *, out_dim: Optional[int] = None,
                      semantics: str = "reference", fused_softmax: bool = True,
                      fast_posteriors: bool = False, backend: str = "cuda"):
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
    on CPU tensors), "torch" the plain versions.  The rank's padded,
    sharded and prepared net and its programs are kept for the last net
    object passed: a repeat call with the same net moves no weights.
    JAX caches its executables per net structure instead; a prepared torch
    net holds the weights, so it is keyed on the net itself.
    """
    data, model = mesh_shape(mesh)
    defaults = EngineConfig()
    rows_multiple = defaults.frame_bucket * data
    cached: list = [None]  # (weakref to the net, device, rank net, programs)

    def prepared(qnet: QuantizedNet, device):
        hit = cached[0]
        if hit is not None and hit[0]() is qnet and hit[1] == device:
            return hit[2], hit[3]
        lanes = kernels.TILE_N if backend == "cuda" else 1
        net = pad_qnet(qnet, lanes=lanes, out_lanes=kernels.TILE_N * model)
        net = shard_qnet(net, mesh).to(device)
        if backend == "cuda":
            net = cuda_backend.prepare(net)
        programs = make_mesh_programs(
            mesh, out_dim=qnet.output_dim if out_dim is None else out_dim, backend=backend,
            semantics=semantics, fused_softmax=fused_softmax,
            fast_posteriors=fast_posteriors, hstack=build_hidden_stack(net),
            stack_max_frames=defaults.stack_hidden_max_frames)
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
                width = net.biases[-1].shape[0] * model  # the padded output width
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
                    semantics: str = "reference",
                    out_dim: Optional[int] = None) -> torch.Tensor:
    """Explicit-collective scoring of a whole batch on every rank.

    qnet: the whole net in the JAX layout, its output width divisible by the
    model axis (pad_qnet(out_lanes=128 * model)); its true senone count
    keeps padding columns out of the softmax by default.  frames [B, in] on
    this rank's device, B divisible by the data axis (and by the kernels'
    64-frame tile on the CUDA backend); masks None or [B, N_padded].  Each
    rank scores its rows and columns with the logits kernel (K5) and the
    collective softmax.  Returns the posteriors [B, N_padded], gathered on
    every rank (columns at or beyond out_dim exactly 0), on the frames'
    device."""
    if out_dim is None:
        out_dim = qnet.output_dim
    model_rank = mesh_coords(mesh)[1]
    net = shard_qnet(qnet, mesh).to(frames.device)
    if backend == "cuda":
        net = cuda_backend.prepare(net)
    acts = hidden_forward(net, local_rows(frames, mesh), backend)
    z = output_logits(net, acts, backend)
    local_masks = None if masks is None else local_cols(local_rows(masks, mesh), mesh)
    p = _sharded_posteriors_from_logits(
        z, local_masks, _valid_cols(z.shape[1], out_dim, model_rank, z.device), semantics,
        mesh.get_group(MODEL_AXIS))
    return gather_blocks(p, mesh).to(frames.device)

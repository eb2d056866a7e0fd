"""Scoring engine: the forward passes over a QuantizedNet, in PyTorch.

The counterpart of fastdnn_tpu/engine/scorer.py on one device:

  * `score(frames)`               numpy in, posteriors f32 [n, out] numpy out
  * `score_device(frames)`        device tensor in, device tensor out
  * `score_masked(frames, masks)` the lazy path, a whole utterance at once:
                                  masks [n, out], nonzero = senone active
  * `score_utterances(utts)`      many utterances in one pass
  * `LazyContext`                 frame-by-frame lazy scoring for decoders

The pass has three stages: the float input layer (one K9 launch: the
product and the quantized sigmoid; with config.input_precision "default",
one launch of its 1-pass bf16 variant instead), the hidden trunk (one K3
launch for batches of at most `stack_hidden_max_frames` when the layers
are at most HIDDEN_STACK_MAX_H wide, else one K2 launch per layer; an int4
trunk packed under `config.int4_packed` runs one K7 launch per layer) and
the output layer.  With `fused_softmax` (the default) the output layer and its softmax
are one K4 launch, masked under the lazy semantics for `score_masked`, or
one K6 launch (tile skipping) for lazy_mode="block_sparse"; an output layer
wider than K4 takes (uses_resident_output) runs one K8 stats launch, plain
or skipping, and one normalize launch.  Without `fused_softmax` they
are a K5 logits launch and a library softmax.  LazyContext scores each
frame with one lazy_output launch (the active senones' logits and the
masked softmax, which the JAX package ran as the logits op and XLA), and
lazy_mode="gathered" runs engine.lazy's library product.  With backend
"torch" every kernel's plain PyTorch version (ops/matmul.py) runs instead,
through the same routes: a `Route` holds the backend (engine.backend) and
calls its steps.

A net with low-rank layers (models.feedforward.LowRank) runs each low-rank
hidden layer as one K10 launch, and a low-rank output layer as its
bottleneck (one launch: the signed codes and a scale per frame, inside the
span `fastdnn.output_bottleneck`) then K4's per-row-scale variant, or, in a
LazyContext, lazy_output's over the codes, which `calculate_until_output`
keeps.  Such a net raises at set-up under the knobs that have no low-rank
route (check_lowrank).

A TDNN-F chain net (quant.quantize.QuantizedTdnnf, engine.tdnnf) scores
chunks with their time context: `score_device(chunks)` takes f32
[C, L + T + R, in] and returns the chain output [C, T / 3, out], and
`score` the same in numpy.  Its frames are not independent, so every other
entry raises for it, and the knobs it has no route for raise at set-up
(engine.tdnnf.check_time_context).

Each public entry, and the host stages inside them, record a span while a
torch.profiler runs (utils.timer.span; SPANS below lists the names).

`Scorer(mesh=...)` (parallel.mesh.make_mesh) splits frames over the mesh's
data ranks and the output layer's columns over its model ranks
(parallel.sharded).

Frame counts are bucketed (padded up to `config.frame_bucket`), which also
makes them multiples of every kernel's frame tile.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..config import EngineConfig
from ..ops import kernels
from ..ops import matmul as xops
from ..quant.quantize import QuantizedNet, QuantizedTdnnf
from ..utils.align import aligned_size
from ..utils.timer import span
from . import lazy as _lazy
# uses_resident_output: the gate keeps the JAX package's module and name
from .backend import Backend, output_bottleneck, output_layer, uses_resident_output  # noqa: F401
from .backend import get as get_backend
from .tdnnf import TdnnfRoute, check_time_context, refuse

#: every span this module records: the public entries, then the stages
#: inside them
SPANS = (
    "fastdnn.score",
    "fastdnn.score_device",
    "fastdnn.score_masked",
    "fastdnn.lazy.until_output",
    "fastdnn.lazy.frame",
    "fastdnn.masks",  # the caller's masks to the u8 device masks
    "fastdnn.trunk_layers",  # the trunk one layer kernel at a time (no stack)
    "fastdnn.output_stats",  # the output layer through the stats: K8 and the normalize
    "fastdnn.output_lazy",  # a frame's output layer: one lazy_output launch
    "fastdnn.output_bottleneck",  # a low-rank output layer's first product: one launch
    "fastdnn.output_chain",  # a TDNN-F net's prefinal pair and chain output: four launches
    "fastdnn.finish",  # the gather under a mesh, the wait, the download and numpy
)


def build_hidden_stack(net: QuantizedNet):
    """Stack the equal-width hidden layers for the one-launch trunk
    (ops.kernels.hidden_stack): (w [L, H, H], colsum [L, H], inv_scales [L],
    bias [L, H]) on the net's device.  None for a packed int4 trunk, when
    the topology has fewer than 2 hidden layers or unequal or non-square
    widths, and when H exceeds ops.kernels.HIDDEN_STACK_MAX_H, the widest
    layer the stack kernel holds in shared memory (such a trunk runs one
    layer kernel per layer)."""
    hw = net.weights[:-1]
    if net.packed_int4 or len(hw) < 2 or net.has_lowrank:
        return None
    shape = hw[0].shape
    if shape[0] != shape[1] or any(w.shape != shape for w in hw):
        return None
    if shape[0] > kernels.HIDDEN_STACK_MAX_H:
        return None
    device = hw[0].device
    return (
        torch.stack(hw),
        torch.stack(net.colsum128[:-1]),
        torch.stack(net.inv_scales[:-1]).to(device=device, dtype=torch.float32),
        torch.stack(net.biases[:-1]),
    )


@dataclasses.dataclass(frozen=True, eq=False)
class Route:
    """The settings of the forward pass, bound once: the backend that runs
    its steps and the knobs that pick them (config.EngineConfig; a Scorer
    builds its route from its config).  `out_dim` is the true senone
    count: padding columns never join the softmax."""

    backend: Backend
    out_dim: int
    fused_softmax: bool = False
    fast_posteriors: bool = False
    hstack: Optional[tuple] = None
    stack_max_frames: int = 0
    input_precision: str = "high"
    semantics: str = "reference"
    block_sparse: bool = False

    def hidden(self, net: QuantizedNet, frames: torch.Tensor) -> torch.Tensor:
        """Input layer + all hidden layers -> shifted-int8 activations [B, H].

        The input layer's product follows `input_precision`
        (config.EngineConfig.input_precision).  No process-wide TF32 switch
        reaches it: for "high" and "highest" its plain version takes the
        product in float64 (`ops.matmul.matmul_f32`), its kernel (K9, on a
        net the backend prepared for that precision) as three TF32 products
        per term (3xTF32) in f32 sums; for "default" both round the
        operands to bf16 first (K9's bf16 variant: one bf16 product in f32
        sums).  When `hstack` (see build_hidden_stack) is given and the
        frame count is within `stack_max_frames`, all hidden layers run as
        one launch; otherwise one layer step per layer, inside the span
        `fastdnn.trunk_layers`.  A packed int4 trunk (net.packed_int4) runs
        the packed layer step, a low-rank layer the low-rank step (K10).
        """
        be = self.backend
        acts = be.input_layer(net, frames, self.input_precision)
        if self.hstack is not None and frames.shape[0] <= self.stack_max_frames:
            return be.hidden_stack(acts, self.hstack)
        layer_step = be.hidden_layer_packed if net.packed_int4 else be.hidden_layer
        with span("fastdnn.trunk_layers"):
            for i in range(len(net.weights) - 1):
                layer = (net.weights[i], net.colsum128[i], net.inv_scales[i], net.biases[i])
                bn = net.bottleneck(i)
                acts = layer_step(acts, *layer) if bn is None else be.lowrank_layer(acts, bn, *layer)
        return acts

    def until_output(self, net: QuantizedNet, frames: torch.Tensor):
        """`hidden`, then a low-rank output layer's bottleneck -> (what the
        output product takes: the last hidden activations, or the
        bottleneck's codes s8 [B, k]; their scales f32 [B], or None)."""
        acts = self.hidden(net, frames)
        out_bn = output_bottleneck(net)
        if out_bn is None:
            return acts, None
        with span("fastdnn.output_bottleneck"):
            return self.backend.bottleneck(acts, *out_bn)

    def _output_input(self, net: QuantizedNet, frames: torch.Tensor):
        """`until_output` for the dense routes, which take a low-rank output
        layer's codes through the fused softmax alone (check_lowrank)."""
        acts, row_scale = self.until_output(net, frames)
        if row_scale is not None and not self.fused_softmax:
            raise ValueError("a low-rank output layer runs with the fused softmax only")
        return acts, row_scale

    def score(self, net: QuantizedNet, frames: torch.Tensor) -> torch.Tensor:
        """Full forward pass -> posteriors [B, out_dim] (bf16 only with
        fused_softmax and fast_posteriors)."""
        acts, row_scale = self._output_input(net, frames)
        if self.fused_softmax:
            return self.backend.posteriors(net, acts, None, out_dim=self.out_dim,
                                           fast=self.fast_posteriors, row_scale=row_scale)
        logits = self.backend.output_logits(acts, *output_layer(net))
        return torch.softmax(logits[:, : self.out_dim], dim=-1)

    def score_masked(self, net: QuantizedNet, frames: torch.Tensor,
                     masks: torch.Tensor) -> torch.Tensor:
        """Lazy/masked forward pass -> posteriors [B, out_dim] under
        `semantics`.  masks: u8 [B, out_dim] (or the padded width) on the
        frames' device, nonzero = senone active for that frame.
        block_sparse selects the tile-skipping kernel (fused_softmax only;
        see config.lazy_mode="block_sparse")."""
        acts, row_scale = self._output_input(net, frames)
        if self.fused_softmax:
            # the kernels read masks at the tile-padded width (padding
            # columns are excluded by the out_dim cutoff anyway)
            n_pad = net.padded_output_dim
            if masks.shape[-1] != n_pad:
                masks = torch.nn.functional.pad(masks, (0, n_pad - masks.shape[-1]))
            return self.backend.posteriors(
                net, acts, masks, out_dim=self.out_dim, semantics=self.semantics,
                fast=self.fast_posteriors, block_sparse=self.block_sparse, row_scale=row_scale,
            )
        logits = self.backend.output_logits(acts, *output_layer(net))[:, : self.out_dim]
        return xops.masked_softmax(logits, masks[:, : self.out_dim] != 0, self.semantics)

    def masked_from_acts(self, net: QuantizedNet, acts: torch.Tensor,
                         masks: torch.Tensor, row_scale=None) -> torch.Tensor:
        """Masked posteriors for a few rows of what `until_output` gave: on
        the kernels one lazy_output launch, which computes the active
        senones' logits only; on the plain versions the logits and the
        masked softmax in tensor ops."""
        return self.backend.lazy_output(acts, *output_layer(net), masks, out_dim=self.out_dim,
                                        semantics=self.semantics, row_scale=row_scale)


def check_lowrank(net: QuantizedNet, config: EngineConfig, mesh=None) -> None:
    """Raise ValueError, at set-up, for a net with low-rank layers under a
    knob that has no low-rank route: the output's bottleneck codes take K4's
    per-row-scale variant (f32, dense, fused) and lazy_output's, and K10
    holds a rank of at most ops.kernels.LOWRANK_MAX_RANK.  Either backend
    refuses alike."""
    if not net.has_lowrank:
        return
    refused = {
        "a mesh": mesh is not None,
        "int4_packed=True (a low-rank layer has no int4 form)": config.int4_packed,
        "fused_softmax=False": not config.fused_softmax,
        "fast_posteriors=True": config.fast_posteriors,
        f"lazy_mode={config.lazy_mode!r}": config.lazy_mode in ("block_sparse", "gathered"),
    }
    bad = [name for name, on in refused.items() if on]
    if bad:
        raise ValueError(f"a net with low-rank layers runs on one device with the fused f32 "
                         f"softmax and the dense lazy mode; refused: {', '.join(bad)}")
    for bn in net.bottlenecks:
        if bn is not None and bn.colsum128.shape[0] > kernels.LOWRANK_MAX_RANK:
            raise ValueError(f"rank {bn.colsum128.shape[0]} exceeds the "
                             f"{kernels.LOWRANK_MAX_RANK} the low-rank kernel holds")


def check_block_sparse(backend: Backend, fused_softmax: bool) -> None:
    """lazy_mode="block_sparse" needs the kernels' fused softmax: the tile
    skipping lives inside them."""
    if not (backend.hand_written and fused_softmax):
        raise ValueError(
            "lazy_mode='block_sparse' needs backend='cuda' (or 'auto' on a CUDA device) with "
            "fused_softmax=True: the tile skipping lives inside the masked kernels"
        )


def hidden_forward(
    net: QuantizedNet,
    frames: torch.Tensor,
    backend: str,
    hstack=None,
    stack_max_frames: int = 0,
    input_precision: str = "high",
) -> torch.Tensor:
    """Input layer + all hidden layers -> shifted-int8 activations [B, H]
    on the backend of that name (Route.hidden)."""
    return Route(get_backend(backend), net.output_dim, hstack=hstack,
                 stack_max_frames=stack_max_frames,
                 input_precision=input_precision).hidden(net, frames)


def score_fn(
    net: QuantizedNet,
    frames: torch.Tensor,
    *,
    backend: str,
    out_dim: Optional[int] = None,
    fused_softmax: bool = False,
    fast_posteriors: bool = False,
    hstack=None,
    stack_max_frames: int = 0,
    input_precision: str = "high",
) -> torch.Tensor:
    """Full forward pass -> posteriors [B, out_dim] (Route.score).
    `out_dim` defaults to the net's true senone count."""
    return Route(
        get_backend(backend), net.output_dim if out_dim is None else out_dim,
        fused_softmax=fused_softmax, fast_posteriors=fast_posteriors, hstack=hstack,
        stack_max_frames=stack_max_frames, input_precision=input_precision,
    ).score(net, frames)


def score_masked_fn(
    net: QuantizedNet,
    frames: torch.Tensor,
    masks: torch.Tensor,
    *,
    backend: str,
    semantics: str = "reference",
    out_dim: Optional[int] = None,
    fused_softmax: bool = False,
    fast_posteriors: bool = False,
    hstack=None,
    stack_max_frames: int = 0,
    block_sparse: bool = False,
    input_precision: str = "high",
) -> torch.Tensor:
    """Lazy/masked forward pass -> posteriors [B, out_dim]
    (Route.score_masked).  `out_dim` defaults to the net's true senone
    count."""
    return Route(
        get_backend(backend), net.output_dim if out_dim is None else out_dim,
        fused_softmax=fused_softmax, fast_posteriors=fast_posteriors, hstack=hstack,
        stack_max_frames=stack_max_frames, input_precision=input_precision,
        semantics=semantics, block_sparse=block_sparse,
    ).score_masked(net, frames, masks)


def tuned_config(config: EngineConfig, net: QuantizedNet, backend: Backend,
                 device) -> EngineConfig:
    """`config` with the registry's knobs for this net and card filled in
    (tuning.apply_tuned) on the kernels' backend in a process that is not
    one of several ranks; unchanged otherwise.  Ranks skip the registry, as the
    JAX package's multi-process pods do: the file is per-host state, and
    ranks resolving different knobs would run different schedules."""
    if not (backend.hand_written and config.autotuned):
        return config
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        return config
    from .. import tuning

    return tuning.apply_tuned(config, net, tuning.device_kind(device))


class Scorer:
    """User-facing engine around one QuantizedNet on one device.

    `device="cuda"` (the default) runs the hand-written kernels and raises
    when CUDA is absent; `device="cpu"` runs the plain versions.  The net is
    prepared for the backend once, here (engine.backend.Backend.prepare:
    padded, packed with `config.int4_packed`, sharded, on the device and in
    the backend's layout), and the knobs are bound once into a `Route`.
    The gathered lazy path reads the mask union on the host, as the JAX
    package does.  On the kernels' backend, in a process that is not one of
    several ranks, the measured launch-knob registry (tuning.py) fills in
    knobs left at their defaults (`tuned_config`).

    `mesh` (a ("data", "model") DeviceMesh, parallel.mesh.make_mesh) makes
    the same API tensor-parallel across the ranks of a process group: every
    rank constructs the Scorer and makes the same calls with the same host
    inputs, scores its share of the frame rows (data axis) and of the output
    layer's columns (model axis; the output is padded to 128 x model
    columns) on `device`, and every public method (score, score_masked,
    score_utterances, LazyContext) returns on every rank the same
    posteriors one device would (parallel.sharded.make_mesh_programs).  The
    gathered lazy path is single-device only; lazy_mode="auto" stays dense.
    """

    def __init__(
        self,
        net: QuantizedNet,
        config: Optional[EngineConfig] = None,
        device="cuda",
        mesh=None,
    ):
        self.config = config or EngineConfig()
        self.device = torch.device(device)
        self.mesh = mesh
        xops.check_input_precision(self.config.input_precision)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Scorer(device='cuda'): CUDA is not available; pass device='cpu' "
                "to score with the plain PyTorch versions"
            )
        self._backend = get_backend(self.config.resolve_backend(self.device))
        #: (left, right) rows of context of a net with time context, else None
        self.context = net.context() if isinstance(net, QuantizedTdnnf) else None
        if self.context is not None:
            self._init_time_context(net, mesh)
            return
        # measured launch knobs for this (net topology, card) replace those
        # left at their defaults; explicit knobs win (tuning.py)
        self.config = tuned_config(self.config, net, self._backend, self.device)
        check_lowrank(net, self.config, mesh)
        if self.config.lazy_mode == "block_sparse":
            check_block_sparse(self._backend, self.config.fused_softmax)
        self._data_size, model_size = 1, 1
        if mesh is not None:
            from ..parallel.mesh import mesh_shape

            if self.config.lazy_mode == "gathered":
                raise ValueError(
                    "lazy_mode='gathered' is single-device only; use 'dense', "
                    "'block_sparse' or 'auto' with a mesh"
                )
            self._data_size, model_size = mesh_shape(mesh)
        if self.config.frame_bucket % self._backend.frame_tile:
            raise ValueError(
                f"frame_bucket={self.config.frame_bucket} must be a multiple of "
                f"the kernels' frame tile {self._backend.frame_tile}"
            )
        self._output_dim = net.output_dim
        self._input_dim = net.input_dim
        self.net = self._backend.prepare(net, self.device, mesh=mesh,
                                         int4_packed=self.config.int4_packed,
                                         input_precision=self.config.input_precision)
        # host masks are padded to this width (see _pad_masks): under a
        # mesh the padded output width, whose columns split over the model axis
        self._mask_width = (self.net.padded_output_dim * model_size if mesh is not None
                            else self._output_dim)
        # under a mesh too: a rank holds the whole trunk, so the stack
        # kernel serves it as on one device
        self._hstack = (
            build_hidden_stack(self.net) if self.config.stack_hidden_max_frames > 0 else None
        )
        self._route = Route(
            self._backend, self._output_dim,
            fused_softmax=self.config.fused_softmax,
            fast_posteriors=self.config.fast_posteriors,
            hstack=self._hstack,
            stack_max_frames=self.config.stack_hidden_max_frames,
            input_precision=self.config.input_precision,
            semantics=self.config.lazy_semantics,
            block_sparse=self.config.lazy_mode == "block_sparse",
        )
        self._programs = None
        if mesh is not None:
            from ..parallel.sharded import make_mesh_programs

            self._programs = make_mesh_programs(mesh, self._route)
        self._gather_capacity = min(
            aligned_size(max(int(self._output_dim * self.config.lazy_capacity), 1), 128),
            self._output_dim,
        )

    def _init_time_context(self, net: QuantizedTdnnf, mesh) -> None:
        """Set-up for a net with time context: its refusals, its layout on
        the backend, its route; no launch-knob registry (its knobs are the
        feed-forward routes')."""
        check_time_context(self.config, mesh)
        self._data_size = 1
        self._output_dim = net.output_dim
        self._input_dim = net.input_dim
        self.net = self._backend.prepare_tdnnf(net, self.device)
        self._route = TdnnfRoute(self._backend)
        self._programs = None
        self._hstack = None

    def _chunks(self, chunks: torch.Tensor) -> torch.Tensor:
        """A net with time context: its chain output [C, T / 3, out] of
        chunks [C, L + T + R, input_dim]."""
        if chunks.dim() != 3 or chunks.shape[2] != self.input_dim:
            raise ValueError(f"chunks must be [C, L + T + R, {self.input_dim}], got "
                             f"{tuple(chunks.shape)}")
        return self._route.score(self.net, chunks)

    # -- helpers ------------------------------------------------------------

    @property
    def backend(self) -> str:
        """The backend's name, "cuda" or "torch"."""
        return self._backend.name

    @property
    def input_dim(self) -> int:
        return self._input_dim

    @property
    def output_dim(self) -> int:
        """True (unpadded) senone count."""
        return self._output_dim

    def _prepare(self, frames: np.ndarray) -> tuple[torch.Tensor, int]:
        """Validate dims, zero-pad the feature dim and bucket the frame
        count (under a mesh, so that every data rank gets whole buckets).
        Returns (padded frames on the device, true count)."""
        if frames.ndim != 2:
            raise ValueError(f"frames must be [n, dim], got shape {frames.shape}")
        n, dim = frames.shape
        if dim > self.input_dim:
            raise ValueError(
                f"input vector size {dim} must be <= network input size {self.input_dim}"
            )
        bucket = self._bucket(n)
        if (bucket, dim) != (n, self.input_dim):
            padded = np.zeros((bucket, self.input_dim), np.float32)
            padded[:n, :dim] = frames
            frames = padded
        return self._to_device(frames), n

    def _bucket(self, n: int) -> int:
        """Rows of the padded batch for `n` frames: a multiple of the frame
        bucket, and under a mesh of the bucket times the data axis, so that
        every data rank gets whole buckets."""
        return aligned_size(max(n, 1), self.config.frame_bucket * self._data_size)

    def _to_device(self, array: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(array)).to(self.device)

    def _pad_masks(self, masks: np.ndarray, pad_n: int) -> np.ndarray:
        """[n, output_dim] host masks -> u8 [pad_n, output_dim], rows past n
        inactive (the masked program pads the width itself); under a mesh
        the padded output width, whose columns split over the model axis."""
        out = np.zeros((pad_n, self._mask_width), dtype=np.uint8)
        out[: masks.shape[0], : self._output_dim] = masks != 0
        return out

    def _masks(self, masks: np.ndarray, pad_n: int) -> tuple[np.ndarray, torch.Tensor]:
        """The caller's masks -> (the padded u8 masks on the host
        (_pad_masks), the same on the device)."""
        with span("fastdnn.masks"):
            padded = self._pad_masks(masks, pad_n)
            return padded, self._to_device(padded)

    def _local(self, x: torch.Tensor, cols: bool = False) -> torch.Tensor:
        """This rank's rows (and, for masks, columns) of a batch; the batch
        itself on one device."""
        if self.mesh is None:
            return x
        from ..parallel.mesh import local_cols, local_rows

        x = local_rows(x, self.mesh)
        return local_cols(x, self.mesh) if cols else x

    def _finish(self, out: torch.Tensor, n: int) -> np.ndarray:
        """Device posteriors -> host [n, output_dim] f32 (bf16 widened);
        under a mesh, every rank's block gathered first."""
        with span("fastdnn.finish"):
            if self.mesh is not None:
                from ..parallel.mesh import gather_blocks

                out = gather_blocks(out, self.mesh)[:, : self._output_dim]
            return out[:n].float().cpu().numpy()

    def _run(self, frames: torch.Tensor) -> torch.Tensor:
        """Posteriors of this rank's block of a padded batch."""
        if self._programs is not None:
            return self._run_local(self._local(frames))
        return self._route.score(self.net, frames)

    def _run_masked(self, frames: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
        if self._programs is not None:
            return self._run_local(self._local(frames), self._local(masks, cols=True))
        return self._route.score_masked(self.net, frames, masks)

    def _run_local(self, frames: torch.Tensor, masks: Optional[torch.Tensor] = None):
        """Mesh only: this rank's block of posteriors from rows (and mask
        columns) that are already this rank's, as a multi-process worker
        receives them (parallel.service)."""
        if masks is None:
            return self._programs[0](self.net, frames)
        return self._programs[1](self.net, frames, masks)

    def _hidden(self, frames: torch.Tensor) -> torch.Tensor:
        """Input layer + hidden trunk -> last-hidden s8 activations of the
        whole batch (under a mesh, each data rank's rows gathered)."""
        if self._programs is not None:
            from ..parallel.mesh import gather_rows

            acts = self._programs[2](self.net, self._local(frames))
            return gather_rows(acts, self.mesh).to(self.device)
        return self._route.hidden(self.net, frames)

    def _until_output(self, frames: torch.Tensor) -> tuple:
        """`_hidden`, then a low-rank output layer's bottleneck -> (what the
        output product takes for the whole batch, its row scales or None;
        Route.until_output).  A mesh holds no low-rank net (check_lowrank)."""
        if self._programs is not None:
            return self._hidden(frames), None
        return self._route.until_output(self.net, frames)

    def _gathered(self, acts, masks, idx) -> torch.Tensor:
        return _lazy.gathered_output_posteriors(
            self.net, acts, masks, idx, out_dim=self._output_dim,
            semantics=self.config.lazy_semantics, backend=self._backend,
        )

    # -- public API ----------------------------------------------------------

    def score(self, frames) -> np.ndarray:
        """Posteriors f32 [n, out] for a frame batch."""
        with span("fastdnn.score"):
            frames = np.asarray(frames, dtype=np.float32)
            if self.context is not None:
                return self._score_chunks(frames)
            if frames.ndim == 2 and frames.shape[0] == 0:
                return np.zeros((0, self.output_dim), np.float32)
            padded, n = self._prepare(frames)
            with torch.inference_mode():
                return self._finish(self._run(padded), n)

    def _score_chunks(self, chunks: np.ndarray) -> np.ndarray:
        """`score` for a net with time context: chunks [C, L + T + R, dim]
        (dim <= input_dim, zero-padded) -> [C, T / 3, out] numpy."""
        if chunks.ndim != 3 or chunks.shape[2] > self.input_dim:
            raise ValueError(f"chunks must be [C, L + T + R, <= {self.input_dim}], got "
                             f"{chunks.shape}")
        if chunks.shape[2] < self.input_dim:
            padded = np.zeros((*chunks.shape[:2], self.input_dim), np.float32)
            padded[:, :, : chunks.shape[2]] = chunks
            chunks = padded
        with torch.inference_mode():
            out = self._chunks(self._to_device(chunks))
        with span("fastdnn.finish"):
            return out.cpu().numpy()

    def score_device(self, frames: torch.Tensor) -> torch.Tensor:
        """Device-resident variant: f32 [B, input_dim] on the scorer's
        device -> [B, output_dim] on it, with no host transfer and no
        padding (on the CUDA backend B must be a multiple of the kernels'
        frame tile, as the bucketed counts are).

        Under a mesh every rank passes the whole batch (B divisible by the
        data axis) and gets back its own block, with no gather: rows
        [d B / data, (d + 1) B / data) and, with model > 1, the rank's
        n_local columns of the padded output width (padding columns 0);
        with model = 1, [B / data, output_dim].  The JAX package's mesh
        variant returns the padded-width global array instead, sharded
        over the devices of its one program; here nothing spans ranks
        without a collective, so each rank keeps what it computed.

        A net with time context takes chunks f32 [C, L + T + R,
        input_dim] (`context` = (L, R)) and returns the chain output
        [C, T / 3, output_dim] (engine.tdnnf)."""
        with span("fastdnn.score_device"):
            if frames.device.type != self.device.type or frames.dtype != torch.float32:
                raise ValueError(
                    f"score_device wants f32 frames on {self.device}, got "
                    f"{frames.dtype} on {frames.device}"
                )
            with torch.inference_mode():
                if self.context is not None:
                    return self._chunks(frames)
                return self._run(frames)

    def score_masked(self, frames, masks) -> np.ndarray:
        """Lazy path, whole utterance at once: masks [n, out] (nonzero =
        active).  The dense masked kernel unless config.lazy_mode asks for
        "gathered" or "block_sparse"."""
        with span("fastdnn.score_masked"):
            if self.context is not None:
                raise refuse("score_masked")
            frames = np.asarray(frames, dtype=np.float32)
            masks = np.asarray(masks)
            if masks.shape != (frames.shape[0], self.output_dim):
                raise ValueError(
                    f"masks must be [n={frames.shape[0]}, out={self.output_dim}], "
                    f"got {masks.shape}"
                )
            padded, n = self._prepare(frames)
            masks_p, masks_d = self._masks(masks, padded.shape[0])
            with torch.inference_mode():
                if self._use_gathered(masks_p):
                    idx, _ = _lazy.union_active_indices(masks_p, self._gather_capacity)
                    out = self._gathered(self._hidden(padded), masks_d, self._to_device(idx))
                else:
                    out = self._run_masked(padded, masks_d)
                return self._finish(out, n)

    def _use_gathered(self, masks: np.ndarray) -> bool:
        if self.config.lazy_mode != "gathered":
            # "auto" resolves to dense, as in the JAX package; gathered runs
            # only on explicit request (and never under a mesh)
            return False
        union = int(masks.any(axis=0).sum())
        if union > self._gather_capacity:
            raise ValueError(
                f"active union {union} exceeds gather capacity "
                f"{self._gather_capacity}; raise config.lazy_capacity or "
                "use lazy_mode='dense'"
            )
        return True

    def score_utterances(self, utterances):
        """Score many utterances in one pass.

        Frames are independent, so utterances are concatenated into one
        frame batch and split back.  Accepts a dict {id: [n, dim]} or a list
        of [n, dim] arrays; returns the same container shape.
        """
        if self.context is not None:
            raise refuse("score_utterances")
        keys = None
        if isinstance(utterances, dict):
            keys = list(utterances.keys())
            mats = [np.asarray(utterances[k], np.float32) for k in keys]
        else:
            mats = [np.asarray(u, np.float32) for u in utterances]
        if not mats:
            return {} if keys is not None else []
        counts = [m.shape[0] for m in mats]
        out = self.score(np.concatenate(mats, axis=0))
        splits = np.split(out, np.cumsum(counts)[:-1])
        if keys is not None:
            return dict(zip(keys, splits))
        return list(splits)

    def _masked_from_acts(self, acts: torch.Tensor, masks: torch.Tensor,
                          row_scale=None) -> torch.Tensor:
        """Device posteriors for a few rows of stored last-hidden
        activations (a low-rank output layer's codes, with their row
        scales) and their device masks (_masks), which have the rows padded
        to split over the data axis under a mesh."""
        rows = masks.shape[0]
        if rows != acts.shape[0]:
            acts = torch.nn.functional.pad(acts, (0, 0, 0, rows - acts.shape[0]))
        if self._programs is not None:
            return self._programs[3](self.net, self._local(acts), self._local(masks, True))
        return self._route.masked_from_acts(self.net, acts, masks, row_scale)

    def new_lazy_context(self, input_vector_count: int) -> "LazyContext":
        """The reference's QuantizedDnn.getNewLazyContext."""
        return LazyContext(self, input_vector_count)


class _LazyStaging:
    """A LazyContext's buffers for one frame's two host copies, reused by
    every frame of the context: a pinned u8 mask row at the scorer's mask
    width and its device twin, a pinned f32 posterior row, and the event
    that the frame's download records."""

    def __init__(self, width: int, out_dim: int, device: torch.device):
        # from torch's caching host allocator: a dropped context's rows go
        # back to its cache, so a context per utterance pins nothing new
        self.mask_host = torch.zeros((1, width), dtype=torch.uint8, pin_memory=True)
        self.mask_device = torch.empty((1, width), dtype=torch.uint8, device=device)
        self.posteriors_host = torch.empty((1, out_dim), dtype=torch.float32, pin_memory=True)
        self.done = torch.cuda.Event()
        self.mask = self.mask_host.numpy()
        # the caller's columns, as bool over the same bytes; the padding
        # columns past them stay 0 from the fill above
        self.active = self.mask[0, :out_dim].view(np.bool_)
        self.posteriors = self.posteriors_host.numpy()[0]


class LazyContext:
    """Frame-by-frame lazy scoring, the reference's LazyContext:
    `calculate_until_output(frames)` runs everything up to the last hidden
    layer once and keeps the activations on the device; each
    `calculate_for_output_nodes(mask)` scores the next frame's senones.

    On a CUDA device without a mesh a frame's two host copies go through
    pinned buffers that the context makes on its first frame and reuses
    (`_LazyStaging`): the mask is written into a pinned row and uploaded
    without blocking, the posteriors are downloaded without blocking into a
    pinned row, and the frame waits on an event recorded after that
    download, not on the whole stream, which other threads' contexts
    share.  The returned row is a copy, the caller's own: no later frame,
    of this context or another, writes to it.  On the CPU and under a mesh
    (whose rows pad to the data axis and gather across ranks) a frame takes
    the batch entries' pageable path.

    For throughput prefer Scorer.score_masked: this pays one launch and one
    host round trip per frame.
    """

    def __init__(self, scorer: Scorer, input_vector_count: int):
        if scorer.context is not None:
            raise refuse("LazyContext")
        self._scorer = scorer
        self.input_vector_count = input_vector_count
        self.current_vector_index = 0
        self._acts: Optional[torch.Tensor] = None
        self._row_scale: Optional[torch.Tensor] = None
        self._staged = scorer.device.type == "cuda" and scorer.mesh is None
        self._staging: Optional[_LazyStaging] = None

    def calculate_until_output(self, frames) -> None:
        with span("fastdnn.lazy.until_output"):
            frames = np.asarray(frames, dtype=np.float32)
            if frames.shape[0] != self.input_vector_count:
                raise ValueError(
                    f"expected {self.input_vector_count} frames, got {frames.shape[0]}"
                )
            padded, _ = self._scorer._prepare(frames)
            with torch.inference_mode():
                self._acts, self._row_scale = self._scorer._until_output(padded)
            self.current_vector_index = 0  # the context is reusable across utterances

    def calculate_for_output_nodes(self, mask) -> np.ndarray:
        """Posteriors f32 [out] for the next frame given its active-node mask."""
        with span("fastdnn.lazy.frame"):
            if self._acts is None:
                raise RuntimeError("call calculate_until_output first")
            i = self.current_vector_index
            if i >= self.input_vector_count:
                raise IndexError("all frames already consumed")
            with torch.inference_mode():
                acts_i = self._acts[i : i + 1]
                scale_i = None if self._row_scale is None else self._row_scale[i : i + 1]
                if self._staged:
                    res = self._staged_frame(acts_i, scale_i, mask)
                else:
                    res = self._pageable_frame(acts_i, scale_i, mask)
            self.current_vector_index += 1
            return res

    def _output(self, acts_i: torch.Tensor, scale_i, mask_p: np.ndarray, mask_d: torch.Tensor):
        scorer = self._scorer
        with span("fastdnn.output_lazy"):
            if scorer._use_gathered(mask_p):
                idx, _ = _lazy.union_active_indices(mask_p, scorer._gather_capacity)
                return scorer._gathered(acts_i, mask_d, scorer._to_device(idx))
            return scorer._masked_from_acts(acts_i, mask_d, scale_i)

    def _pageable_frame(self, acts_i: torch.Tensor, scale_i, mask) -> np.ndarray:
        scorer = self._scorer
        # under a mesh the row is padded to split over the data axis
        mask_p, mask_d = scorer._masks(np.asarray(mask).reshape(1, -1),
                                       aligned_size(1, scorer._data_size))
        return scorer._finish(self._output(acts_i, scale_i, mask_p, mask_d), 1)[0]

    def _staged_frame(self, acts_i: torch.Tensor, scale_i, mask) -> np.ndarray:
        st = self._staging
        if st is None:
            scorer = self._scorer
            st = self._staging = _LazyStaging(scorer._mask_width, scorer.output_dim,
                                              acts_i.device)
        with span("fastdnn.masks"):
            # a mask of another size raises here, as _pad_masks's copy does
            np.not_equal(np.asarray(mask).reshape(-1), 0, out=st.active)
            st.mask_device.copy_(st.mask_host, non_blocking=True)
        out = self._output(acts_i, scale_i, st.mask, st.mask_device)
        with span("fastdnn.finish"):
            st.posteriors_host.copy_(out, non_blocking=True)
            st.done.record(torch.cuda.current_stream(acts_i.device))
            # The upload, the kernel and the download ran in that order on
            # this one stream, so once the event has fired this frame's
            # upload has finished too: the next frame may overwrite both
            # pinned rows and the device mask.
            st.done.synchronize()
            return st.posteriors.copy()

"""Scoring engine: the forward passes over a QuantizedNet, in PyTorch.

The counterpart of fastdnn_tpu/engine/scorer.py on one device:

  * `score(frames)`               numpy in, posteriors f32 [n, out] numpy out
  * `score_device(frames)`        device tensor in, device tensor out
  * `score_masked(frames, masks)` the lazy path, a whole utterance at once:
                                  masks [n, out], nonzero = senone active
  * `score_utterances(utts)`      many utterances in one pass
  * `LazyContext`                 frame-by-frame lazy scoring for decoders

The pass has three stages: the float input layer (one K9 launch: the
product and the quantized sigmoid), the hidden trunk (one K3 launch for batches of
at most `stack_hidden_max_frames` when the layers are at most
HIDDEN_STACK_MAX_H wide, else one K2 launch per layer; an int4 trunk packed
under `config.int4_packed` runs one K7 launch per layer) and the output
layer.  With `fused_softmax` (the default) the output layer and its softmax
are one K4 launch, masked under the lazy semantics for `score_masked`, or
one K6 launch (tile skipping) for lazy_mode="block_sparse"; an output layer
wider than K4 takes (uses_resident_output) runs one K8 stats launch, plain
or skipping, and one normalize launch.  Without `fused_softmax` they
are a K5 logits launch and a library softmax.  LazyContext scores each
frame with K5 and the masked softmax in plain tensor ops, as the JAX
package did in XLA, and lazy_mode="gathered" runs engine.lazy's library
product.  With backend "torch" every kernel's plain PyTorch version
(ops/matmul.py) runs instead, through the same routes.

`Scorer(mesh=...)` (parallel.mesh.make_mesh) splits frames over the mesh's
data ranks and the output layer's columns over its model ranks
(parallel.sharded).

Frame counts are bucketed (padded up to `config.frame_bucket`), which also
makes them multiples of every kernel's frame tile.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import EngineConfig
from ..ops import kernels
from ..ops import matmul as xops
from ..quant.quantize import QuantizedNet, pack_int4_trunk, pad_qnet
from ..utils.align import aligned_size
from . import cuda_backend
from . import lazy as _lazy


def build_hidden_stack(net: QuantizedNet):
    """Stack the equal-width hidden layers for the one-launch trunk
    (ops.kernels.hidden_stack): (w [L, H, H], colsum [L, H], inv_scales [L],
    bias [L, H]) on the net's device.  None for a packed int4 trunk, when
    the topology has fewer than 2 hidden layers or unequal or non-square
    widths, and when H exceeds ops.kernels.HIDDEN_STACK_MAX_H, the widest
    layer the stack kernel holds in shared memory (such a trunk runs one
    layer kernel per layer)."""
    hw = net.weights[:-1]
    if net.packed_int4 or len(hw) < 2:
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


def hidden_forward(
    net: QuantizedNet,
    frames: torch.Tensor,
    backend: str,
    hstack=None,
    stack_max_frames: int = 0,
) -> torch.Tensor:
    """Input layer + all hidden layers -> shifted-int8 activations [B, H].

    No process-wide TF32 switch reaches the input layer: its plain version
    takes the product in float64 (`ops.matmul.matmul_f32`), its kernel (K9,
    on a net made by cuda_backend.prepare) as three TF32 products per term
    (3xTF32) in f32 sums.
    When `hstack` (see build_hidden_stack) is given and the frame count is
    within `stack_max_frames`, all hidden layers run as one launch.  A
    packed int4 trunk (net.packed_int4) runs the packed layer step.
    """
    if backend == "torch":
        steps = xops
        acts = xops.input_layer_step(frames, net.input_w, net.input_b)
    else:
        steps = cuda_backend
        acts = cuda_backend.input_layer_step(frames, net.input_w, net.input_b,
                                             net.input_operand)
    if hstack is not None and frames.shape[0] <= stack_max_frames:
        return steps.hidden_stack_step(acts, hstack)
    layer_step = steps.hidden_layer_step_packed if net.packed_int4 else steps.hidden_layer_step
    for i in range(len(net.weights) - 1):
        acts = layer_step(
            acts, net.weights[i], net.colsum128[i], net.inv_scales[i], net.biases[i]
        )
    return acts


def _output_args(net: QuantizedNet):
    return (net.weights[-1], net.colsum128[-1], net.inv_scales[-1], net.biases[-1])


def output_logits(net: QuantizedNet, acts: torch.Tensor, backend: str) -> torch.Tensor:
    """Output-layer logits f32 [B, N] (K5, or its plain version)."""
    steps = xops if backend == "torch" else cuda_backend
    return steps.output_logits(acts, *_output_args(net))


def _output_input_width(net: QuantizedNet) -> int:
    """K of the output layer, read from the previous layer's bias (the
    same in either weight layout, packed or not)."""
    return (net.biases[-2] if len(net.biases) > 1 else net.input_b).shape[0]


def uses_resident_output(net: QuantizedNet, *, block_sparse: bool = False) -> bool:
    """True when the fused output layer runs the resident softmax kernel
    (K4; K6 with block_sparse), False when it falls back to the stats kernel
    (K8) and a normalize pass, as the JAX package's gate of that name does.

    The JAX gate sizes the whole [K, N] weight and two working sets against
    the TPU's VMEM (48 MB, and a 100 MB clamp).  Those numbers are the
    TPU's: K4 never holds the weight, it keeps a 64-frame block of
    activations (64 K bytes) in shared memory beside its weight ring, so N
    does not enter and the limit is K <= ops.kernels.RESIDENT_SOFTMAX_MAX_K.
    K6 is the same kernel with a list of its active tiles beside the ring,
    which fits at that K too, so `block_sparse` does not change the
    answer."""
    return _output_input_width(net) <= kernels.RESIDENT_SOFTMAX_MAX_K


def _fused_posteriors(net, acts, masks, *, backend, out_dim, semantics, fast, block_sparse=False):
    """Output layer + softmax: K4 (masks optional, bf16 with `fast`), or K6
    for masked block-sparse calls (f32 only), when the output layer fits
    them (uses_resident_output); otherwise one K8 launch (skipping for
    block-sparse) and one normalize launch.  The plain versions of
    the same routes on backend "torch".  Unlike the JAX package, no batch is
    cut into 8192-row chunks: that bounded a VMEM scratch of the TPU kernel,
    and K8 keeps its row stats in registers."""
    args = (acts, *_output_args(net))
    resident = uses_resident_output(net, block_sparse=block_sparse)
    plain = backend == "torch"
    if block_sparse and masks is not None:
        if plain:
            fn = (xops.output_posteriors_block_sparse if resident
                  else xops.output_posteriors_block_sparse_stats)
            return fn(*args, masks, out_dim=out_dim, semantics=semantics)
        return cuda_backend.output_posteriors_block_sparse(
            *args, masks, out_dim=out_dim, semantics=semantics, resident=resident
        )
    if plain:
        fn = xops.output_posteriors if resident else xops.output_posteriors_stats
    else:
        fn = cuda_backend.output_posteriors_resident if resident else cuda_backend.output_posteriors
    return fn(*args, masks, out_dim=out_dim, semantics=semantics, fast=fast)


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
) -> torch.Tensor:
    """Full forward pass -> posteriors [B, out_dim] (bf16 only with
    fused_softmax and fast_posteriors).  `out_dim` defaults to the net's
    true senone count; padding columns never join the softmax."""
    if out_dim is None:
        out_dim = net.output_dim
    acts = hidden_forward(net, frames, backend, hstack, stack_max_frames)
    if fused_softmax:
        return _fused_posteriors(
            net, acts, None, backend=backend, out_dim=out_dim, semantics="reference",
            fast=fast_posteriors,
        )
    return torch.softmax(output_logits(net, acts, backend)[:, :out_dim], dim=-1)


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
) -> torch.Tensor:
    """Lazy/masked forward pass -> posteriors [B, out_dim].

    masks: u8 [B, out_dim] (or the padded width) on the frames' device,
    nonzero = senone active for that frame.  block_sparse selects the
    tile-skipping kernel (fused_softmax only; see
    config.lazy_mode="block_sparse").
    """
    if out_dim is None:
        out_dim = net.output_dim
    acts = hidden_forward(net, frames, backend, hstack, stack_max_frames)
    if fused_softmax:
        # the kernels read masks at the tile-padded width (padding columns
        # are excluded by the out_dim cutoff anyway); the CUDA backend keeps
        # the weight in the kernels' layout [N, K] (cuda_backend.prepare)
        n_pad = net.weights[-1].shape[0 if backend == "cuda" else 1]
        if masks.shape[-1] != n_pad:
            masks = torch.nn.functional.pad(masks, (0, n_pad - masks.shape[-1]))
        return _fused_posteriors(
            net, acts, masks, backend=backend, out_dim=out_dim, semantics=semantics,
            fast=fast_posteriors, block_sparse=block_sparse,
        )
    logits = output_logits(net, acts, backend)[:, :out_dim]
    return xops.masked_softmax(logits, masks[:, :out_dim] != 0, semantics)


def masked_posteriors_from_acts(net, acts, masks, *, backend, semantics, out_dim):
    """Masked posteriors for a few rows of last-hidden activations: the
    logits (K5) and the masked softmax in plain tensor ops.  The kernel
    takes whole 64-frame tiles, so the rows are padded for it and cut back
    after."""
    n = acts.shape[0]
    if backend == "cuda" and n % kernels.OUTPUT_LOGITS_FRAMES:
        pad = kernels.OUTPUT_LOGITS_FRAMES - n % kernels.OUTPUT_LOGITS_FRAMES
        acts = torch.nn.functional.pad(acts, (0, 0, 0, pad))
    logits = output_logits(net, acts, backend)[:n, :out_dim]
    return xops.masked_softmax(logits, masks[:, :out_dim] != 0, semantics)


class Scorer:
    """User-facing engine around one QuantizedNet on one device.

    `device="cuda"` (the default) runs the hand-written kernels and raises
    when CUDA is absent; `device="cpu"` runs the plain versions.  The
    weights are moved to the device once, here; for the CUDA backend they
    are also padded to the kernels' tiles and transposed into the kernels'
    layout (cuda_backend.prepare).  The per-layer scales stay host scalars:
    the kernels take them by value, so scoring never waits on the device to
    read one.  With `config.int4_packed` an int4 trunk is packed after the
    padding and before the layout change.  The gathered lazy path reads the
    mask union on the host, as the JAX package does.

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
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Scorer(device='cuda'): CUDA is not available; pass device='cpu' "
                "to score with the plain PyTorch versions"
            )
        self._backend = self.config.resolve_backend(self.device)
        if self.config.lazy_mode == "block_sparse" and not (
            self._backend == "cuda" and self.config.fused_softmax
        ):
            raise ValueError(
                "lazy_mode='block_sparse' needs backend='cuda' (or 'auto' on a CUDA "
                "device) with fused_softmax=True: the tile skipping lives inside the "
                "masked kernel"
            )
        self._data_size, model_size = 1, 1
        if mesh is not None:
            from ..parallel.mesh import mesh_shape

            if self.config.lazy_mode == "gathered":
                raise ValueError(
                    "lazy_mode='gathered' is single-device only; use 'dense', "
                    "'block_sparse' or 'auto' with a mesh"
                )
            self._data_size, model_size = mesh_shape(mesh)
        if self._backend == "cuda":
            tile = max(kernels.HIDDEN_LAYER_FRAMES, kernels.HIDDEN_STACK_FRAMES,
                       kernels.RESIDENT_SOFTMAX_FRAMES, kernels.OUTPUT_LOGITS_FRAMES,
                       kernels.FLASH_STATS_FRAMES)
            if self.config.frame_bucket % tile:
                raise ValueError(
                    f"frame_bucket={self.config.frame_bucket} must be a multiple of "
                    f"the kernels' frame tile {tile}"
                )
            # the output splits into 128-column shards, one per model rank
            net = pad_qnet(net, lanes=kernels.TILE_N, out_lanes=kernels.TILE_N * model_size)
        elif model_size > 1:
            net = pad_qnet(net, lanes=1, out_lanes=kernels.TILE_N * model_size)
        if self.config.int4_packed:
            net = pack_int4_trunk(net)  # after padding: the halves split at the padded K
        self._output_dim = net.output_dim
        self._input_dim = net.input_dim
        self._padded_output_dim = net.padded_output_dim
        # host masks are padded to this width (see _pad_masks)
        self._mask_width = self._padded_output_dim if mesh is not None else self._output_dim
        if mesh is not None:
            from ..parallel.mesh import shard_qnet

            net = shard_qnet(net, mesh)
        self.net = net.to(self.device)
        if self._backend == "cuda":
            self.net = cuda_backend.prepare(self.net)
        # under a mesh too: a rank holds the whole trunk, so the stack
        # kernel serves it as on one device
        self._hstack = (
            build_hidden_stack(self.net) if self.config.stack_hidden_max_frames > 0 else None
        )
        self._kw = dict(
            backend=self._backend,
            out_dim=self._output_dim,
            fused_softmax=self.config.fused_softmax,
            fast_posteriors=self.config.fast_posteriors,
            hstack=self._hstack,
            stack_max_frames=self.config.stack_hidden_max_frames,
        )
        self._programs = None
        if mesh is not None:
            from ..parallel.sharded import make_mesh_programs

            self._programs = make_mesh_programs(
                mesh, semantics=self.config.lazy_semantics,
                block_sparse=self.config.lazy_mode == "block_sparse", **self._kw,
            )
        self._gather_capacity = min(
            aligned_size(max(int(self._output_dim * self.config.lazy_capacity), 1), 128),
            self._output_dim,
        )

    # -- helpers ------------------------------------------------------------

    @property
    def backend(self) -> str:
        return self._backend

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
        if self.mesh is not None:
            from ..parallel.mesh import gather_blocks

            out = gather_blocks(out, self.mesh)[:, : self._output_dim]
        return out[:n].float().cpu().numpy()

    def _run(self, frames: torch.Tensor) -> torch.Tensor:
        """Posteriors of this rank's block of a padded batch."""
        if self._programs is not None:
            return self._run_local(self._local(frames))
        return score_fn(self.net, frames, **self._kw)

    def _run_masked(self, frames: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
        if self._programs is not None:
            return self._run_local(self._local(frames), self._local(masks, cols=True))
        return score_masked_fn(
            self.net, frames, masks, semantics=self.config.lazy_semantics,
            block_sparse=self.config.lazy_mode == "block_sparse", **self._kw,
        )

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
        return hidden_forward(
            self.net, frames, self._backend, self._hstack, self.config.stack_hidden_max_frames
        )

    def _gathered(self, acts, masks, idx) -> torch.Tensor:
        return _lazy.gathered_output_posteriors(
            self.net, acts, masks, idx, out_dim=self._output_dim,
            semantics=self.config.lazy_semantics, kernel_layout=self._backend == "cuda",
        )

    # -- public API ----------------------------------------------------------

    def score(self, frames) -> np.ndarray:
        """Posteriors f32 [n, out] for a frame batch."""
        frames = np.asarray(frames, dtype=np.float32)
        if frames.ndim == 2 and frames.shape[0] == 0:
            return np.zeros((0, self.output_dim), np.float32)
        padded, n = self._prepare(frames)
        with torch.inference_mode():
            return self._finish(self._run(padded), n)

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
        without a collective, so each rank keeps what it computed."""
        if frames.device.type != self.device.type or frames.dtype != torch.float32:
            raise ValueError(
                f"score_device wants f32 frames on {self.device}, got "
                f"{frames.dtype} on {frames.device}"
            )
        with torch.inference_mode():
            return self._run(frames)

    def score_masked(self, frames, masks) -> np.ndarray:
        """Lazy path, whole utterance at once: masks [n, out] (nonzero =
        active).  The dense masked kernel unless config.lazy_mode asks for
        "gathered" or "block_sparse"."""
        frames = np.asarray(frames, dtype=np.float32)
        masks = np.asarray(masks)
        if masks.shape != (frames.shape[0], self.output_dim):
            raise ValueError(
                f"masks must be [n={frames.shape[0]}, out={self.output_dim}], got {masks.shape}"
            )
        padded, n = self._prepare(frames)
        masks_p = self._pad_masks(masks, padded.shape[0])
        with torch.inference_mode():
            if self._use_gathered(masks_p):
                idx, _ = _lazy.union_active_indices(masks_p, self._gather_capacity)
                out = self._gathered(
                    self._hidden(padded), self._to_device(masks_p), self._to_device(idx)
                )
            else:
                out = self._run_masked(padded, self._to_device(masks_p))
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

    def _score_masked_from_acts(self, acts: torch.Tensor, masks: np.ndarray) -> np.ndarray:
        """Posteriors for a few rows of stored last-hidden activations
        (under a mesh, rows padded to split over the data axis)."""
        b = acts.shape[0]
        rows = aligned_size(b, self._data_size)
        if rows != b:
            acts = torch.nn.functional.pad(acts, (0, 0, 0, rows - b))
        masks_p = self._to_device(self._pad_masks(np.asarray(masks), rows))
        with torch.inference_mode():
            if self._programs is not None:
                out = self._programs[3](self.net, self._local(acts), self._local(masks_p, True))
            else:
                out = masked_posteriors_from_acts(
                    self.net, acts, masks_p, backend=self._backend,
                    semantics=self.config.lazy_semantics, out_dim=self._output_dim,
                )
            return self._finish(out, b)

    def new_lazy_context(self, input_vector_count: int) -> "LazyContext":
        """The reference's QuantizedDnn.getNewLazyContext."""
        return LazyContext(self, input_vector_count)


class LazyContext:
    """Frame-by-frame lazy scoring, the reference's LazyContext:
    `calculate_until_output(frames)` runs everything up to the last hidden
    layer once and keeps the activations on the device; each
    `calculate_for_output_nodes(mask)` scores the next frame's senones.

    For throughput prefer Scorer.score_masked: this pays one launch and one
    host round trip per frame.
    """

    def __init__(self, scorer: Scorer, input_vector_count: int):
        self._scorer = scorer
        self.input_vector_count = input_vector_count
        self.current_vector_index = 0
        self._acts: Optional[torch.Tensor] = None

    def calculate_until_output(self, frames) -> None:
        frames = np.asarray(frames, dtype=np.float32)
        if frames.shape[0] != self.input_vector_count:
            raise ValueError(
                f"expected {self.input_vector_count} frames, got {frames.shape[0]}"
            )
        padded, _ = self._scorer._prepare(frames)
        with torch.inference_mode():
            self._acts = self._scorer._hidden(padded)
        self.current_vector_index = 0  # the context is reusable across utterances

    def calculate_for_output_nodes(self, mask) -> np.ndarray:
        """Posteriors f32 [out] for the next frame given its active-node mask."""
        if self._acts is None:
            raise RuntimeError("call calculate_until_output first")
        i = self.current_vector_index
        if i >= self.input_vector_count:
            raise IndexError("all frames already consumed")
        scorer = self._scorer
        mask = (np.asarray(mask).reshape(1, -1) != 0).astype(np.uint8)
        with torch.inference_mode():
            acts_i = self._acts[i : i + 1]
            if scorer._use_gathered(mask):
                idx, _ = _lazy.union_active_indices(mask, scorer._gather_capacity)
                out = scorer._gathered(acts_i, scorer._to_device(mask), scorer._to_device(idx))
                res = scorer._finish(out, 1)[0]
            else:
                res = scorer._score_masked_from_acts(acts_i, mask)[0]
        self.current_vector_index += 1
        return res

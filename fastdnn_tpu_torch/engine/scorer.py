"""Scoring engine: the dense forward pass over a QuantizedNet, in PyTorch.

The counterpart of fastdnn_tpu/engine/scorer.py (dense path only):

  * `score(frames)`        numpy in, posteriors f32 [n, out] numpy out
  * `score_device(frames)` device tensor in, device tensor out

The pass has three stages: the float input layer (a library matmul, then the
K1 quantized-sigmoid kernel), the hidden trunk (one K3 launch for batches of
at most `stack_hidden_max_frames`, else one K2 launch per layer) and the
output layer with its softmax (one K4 launch).  With backend "torch" every
stage runs its plain PyTorch version instead (ops/matmul.py).

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
from ..quant.quantize import QuantizedNet, pad_qnet
from ..utils.align import aligned_size
from . import cuda_backend


def build_hidden_stack(net: QuantizedNet):
    """Stack the equal-width hidden layers for the one-launch trunk
    (ops.kernels.hidden_stack): (w [L, H, H], colsum [L, H], inv_scales [L],
    bias [L, H]) on the net's device.  None when the topology has fewer
    than 2 hidden layers or unequal or non-square widths."""
    hw = net.weights[:-1]
    if len(hw) < 2:
        return None
    shape = hw[0].shape
    if shape[0] != shape[1] or any(w.shape != shape for w in hw):
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

    The input layer's product is `ops.matmul.matmul_f32`: float64 rounded
    to f32, so the process-wide TF32 switches cannot lower its precision.
    When `hstack` (see build_hidden_stack) is given and the frame count is
    within `stack_max_frames`, all hidden layers run as one launch.
    """
    steps = xops if backend == "torch" else cuda_backend
    acts = steps.input_layer_step(frames, net.input_w, net.input_b)
    if hstack is not None and frames.shape[0] <= stack_max_frames:
        return steps.hidden_stack_step(acts, hstack)
    for i in range(len(net.weights) - 1):
        acts = steps.hidden_layer_step(
            acts, net.weights[i], net.colsum128[i], net.inv_scales[i], net.biases[i]
        )
    return acts


def score_fn(
    net: QuantizedNet,
    frames: torch.Tensor,
    *,
    backend: str,
    out_dim: Optional[int] = None,
    hstack=None,
    stack_max_frames: int = 0,
) -> torch.Tensor:
    """Full forward pass -> posteriors f32 [B, out_dim].  `out_dim`
    defaults to the net's true senone count; padding columns never join
    the softmax."""
    if out_dim is None:
        out_dim = net.output_dim
    acts = hidden_forward(net, frames, backend, hstack, stack_max_frames)
    args = (acts, net.weights[-1], net.colsum128[-1], net.inv_scales[-1], net.biases[-1])
    if backend == "torch":
        return xops.output_posteriors(*args, out_dim=out_dim)
    return cuda_backend.output_posteriors_resident(*args, out_dim=out_dim)


class Scorer:
    """User-facing engine around one QuantizedNet on one device.

    `device="cuda"` (the default) runs the hand-written kernels and raises
    when CUDA is absent; `device="cpu"` runs the plain versions.  The
    weights are moved to the device once, here; for the CUDA backend they
    are also padded to the kernels' tiles and transposed into the kernels'
    layout (cuda_backend.prepare).  The per-layer scales stay host scalars:
    the kernels take them by value, so scoring never waits on the device to
    read one.
    """

    def __init__(
        self,
        net: QuantizedNet,
        config: Optional[EngineConfig] = None,
        device="cuda",
    ):
        self.config = config or EngineConfig()
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Scorer(device='cuda'): CUDA is not available; pass device='cpu' "
                "to score with the plain PyTorch versions"
            )
        self._backend = self.config.resolve_backend(self.device)
        if self._backend == "cuda":
            tile = max(kernels.HIDDEN_LAYER_FRAMES, kernels.HIDDEN_STACK_FRAMES,
                       kernels.RESIDENT_SOFTMAX_FRAMES)
            if self.config.frame_bucket % tile:
                raise ValueError(
                    f"frame_bucket={self.config.frame_bucket} must be a multiple of "
                    f"the kernels' frame tile {tile}"
                )
            net = pad_qnet(net, lanes=kernels.TILE_N, out_lanes=kernels.TILE_N)
        self._output_dim = net.output_dim
        self._input_dim = net.input_dim
        self.net = net.to(self.device)
        if self._backend == "cuda":
            self.net = cuda_backend.prepare(self.net)
        self._hstack = (
            build_hidden_stack(self.net) if self.config.stack_hidden_max_frames > 0 else None
        )

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
        count.  Returns (padded frames on the device, true count)."""
        if frames.ndim != 2:
            raise ValueError(f"frames must be [n, dim], got shape {frames.shape}")
        n, dim = frames.shape
        if dim > self.input_dim:
            raise ValueError(
                f"input vector size {dim} must be <= network input size {self.input_dim}"
            )
        bucket = aligned_size(max(n, 1), self.config.frame_bucket)
        if (bucket, dim) != (n, self.input_dim):
            padded = np.zeros((bucket, self.input_dim), np.float32)
            padded[:n, :dim] = frames
            frames = padded
        return torch.from_numpy(np.ascontiguousarray(frames)).to(self.device), n

    def _finish(self, out: torch.Tensor, n: int) -> np.ndarray:
        """Device posteriors -> host [n, output_dim] f32."""
        return out[:n].cpu().numpy()

    def _run(self, frames: torch.Tensor) -> torch.Tensor:
        return score_fn(
            self.net,
            frames,
            backend=self._backend,
            out_dim=self._output_dim,
            hstack=self._hstack,
            stack_max_frames=self.config.stack_hidden_max_frames,
        )

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
        device -> f32 [B, output_dim] on it, with no host transfer and no
        padding (on the CUDA backend B must be a multiple of the kernels'
        frame tile, as the bucketed counts are)."""
        if frames.device.type != self.device.type or frames.dtype != torch.float32:
            raise ValueError(
                f"score_device wants f32 frames on {self.device}, got "
                f"{frames.dtype} on {frames.device}"
            )
        with torch.inference_mode():
            return self._run(frames)

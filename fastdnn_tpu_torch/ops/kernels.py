"""Python wrappers of the port's hand-written Hopper kernels (csrc/*.cu).

Dispatch rule, with no fallback: a tensor on the CPU goes to the kernel's
plain PyTorch version (ops/matmul.py); a CUDA tensor goes to the kernel,
and a kernel that cannot build or launch raises.  Each wrapper checks
device, dtype, shape and contiguity, allocates its output with
`torch.empty`, launches on the current stream of the tensor's device and
adds one to its launch count (`launch_counts`), which is how a run shows
that its main path went through the kernels.

The kernels read their int8 weights transposed, K contiguous ([N, K], or
[L, N, K] for the stack; `kernel_layout`), the K-major operand that TMA
copies and wgmma reads; the plain versions keep the JAX package's [K, N].
A wrapper given CPU tensors transposes back for its plain version.

    K1 bias_sigmoid_i8                the quantized-sigmoid epilogue as its own kernel
    K9 input_layer                    the float input layer: 3xTF32 product + K1's
                                      epilogue, frames f32 in, s8 out
    K2 hidden_layer                   one int8 hidden layer with the fused epilogue
                                      (activations streamed: any K)
    K3 hidden_stack                   all equal-width hidden layers in one launch
    K4 resident_softmax               int8 output layer + full row softmax, optionally
                                      masked (both lazy semantics) and bf16
    K5 output_logits                  int8 output layer -> f32 logits, no softmax
    K6 resident_softmax_block_sparse  K4 masked, skipping all-inactive
                                      (64-frame x 128-senone) tiles
    K7 hidden_layer_packed            K2 for an int4 layer stored two nibbles
                                      per byte (quant.quantize.pack_int4_trunk),
                                      widened in shared memory
    K8 flash_stats                    int8 output layer -> logits + softmax row
                                      stats (max, sum-exp), masked or not, any K
       flash_stats_block_sparse       K8 skipping all-inactive tiles
       normalize_stats                K8's normalize, exp(z - m) / s, one pass

Masks are uint8 [B, N] at the tile-padded output width, nonzero = active.

Every product runs Hopper's warp-specialised shape (csrc/hopper.cuh: TMA
stages, wgmma products).  K2, K3, K5 and K7 run blocks of 64 frames in
clusters of wgmma_cluster(B) blocks that share weight stages by multicast
(K2 and K5 are one kernel with two epilogues); K4, K6 and K8 run clusters
of 2 blocks that share 64 frames and split the output columns.  K9 takes
128 frames per block.

K9 reads the input weight as `input_layer_operand(w)`: W transposed and
split into two TF32 halves, made once (cuda_backend.prepare).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

import torch

from . import _build
from . import matmul as plain

#: frame-tile multiples of the kernels (BM in csrc/*.cu)
HIDDEN_LAYER_FRAMES = 64
HIDDEN_STACK_FRAMES = 64
RESIDENT_SOFTMAX_FRAMES = 64
OUTPUT_LOGITS_FRAMES = 64
FLASH_STATS_FRAMES = 64
#: the widest output layer the skipping stats kernel takes: each block of a
#: pair lists at most 8192 of its column tiles (csrc/flash_stats.cu)
FLASH_STATS_MAX_SKIP_N = 2 * 8192 * 128
#: K-stage depth and output-column tile of the wgmma loop (kStageK, kTileN
#: in csrc/hopper.cuh); pad_qnet pads node dims to TILE_N
TILE_K = 128
TILE_N = 128
#: Hopper's opt-in shared-memory limit per block, where torch does not say
HOPPER_BLOCK_SMEM = 232448
#: the widest output-layer input K4 and K6 take: their 64-frame activation
#: block (64 K bytes) sits in shared memory beside a 6-stage weight ring
#: (fdn_resident_softmax_wgmma_smem_bytes(2048) = 231,536 bytes, K6 552
#: bytes more for its tile list; one 128-deep step more exceeds
#: HOPPER_BLOCK_SMEM); wider goes to K8
RESIDENT_SOFTMAX_MAX_K = 2048
#: the widest hidden layer K3 takes, for the same reason with 5 stages and
#: the sigmoid table (fdn_hidden_stack_wgmma_smem_bytes(2304) = 231,779
#: bytes); wider runs K2 per layer
HIDDEN_STACK_MAX_H = 2304
#: K9 reads frame and weight rows by TMA, whose rows start on 16-byte
#: boundaries: the operand's K is padded to a multiple of 4 f32
INPUT_K_MULTIPLE = 4
#: blocks per thread-block cluster of K2, K3 and K7: each weight stage
#: leaves L2 once per cluster and is multicast to its blocks.  On the H100
#: clusters of 2 beat 1, and clusters of 4 lost to both (PERF.md)
WGMMA_CLUSTER = 2


@dataclass(frozen=True)
class Kernel:
    """What a kernel is, for reports: its source and the TPU function it
    replaces."""

    source: str
    replaces: str


# wrapper name -> kernel; each wrapper's plain version is named in its docstring
KERNELS = {
    "bias_sigmoid_i8": Kernel(
        "fastdnn_tpu_torch/csrc/bias_sigmoid.cu", "fastdnn_tpu/ops/pallas_kernels.py:50"
    ),
    "input_layer": Kernel(
        "fastdnn_tpu_torch/csrc/input_layer.cu",
        "fastdnn_tpu/ops/pallas_kernels.py:50, fastdnn_tpu/ops/matmul.py:39",
    ),
    "hidden_layer": Kernel(
        "fastdnn_tpu_torch/csrc/hidden_layer.cu", "fastdnn_tpu/ops/pallas_kernels.py:180"
    ),
    "hidden_stack": Kernel(
        "fastdnn_tpu_torch/csrc/hidden_stack.cu", "fastdnn_tpu/ops/pallas_kernels.py:244"
    ),
    "resident_softmax": Kernel(
        "fastdnn_tpu_torch/csrc/resident_softmax.cu", "fastdnn_tpu/ops/pallas_kernels.py:364"
    ),
    "output_logits": Kernel(
        "fastdnn_tpu_torch/csrc/output_logits.cu", "fastdnn_tpu/ops/pallas_kernels.py:1104"
    ),
    "resident_softmax_block_sparse": Kernel(
        "fastdnn_tpu_torch/csrc/resident_softmax.cu", "fastdnn_tpu/ops/pallas_kernels.py:1031"
    ),
    "hidden_layer_packed": Kernel(
        "fastdnn_tpu_torch/csrc/hidden_layer_packed.cu", "fastdnn_tpu/ops/pallas_kernels.py:87"
    ),
    "flash_stats": Kernel(
        "fastdnn_tpu_torch/csrc/flash_stats.cu",
        "fastdnn_tpu/ops/pallas_kernels.py:536, :671",
    ),
    "flash_stats_block_sparse": Kernel(
        "fastdnn_tpu_torch/csrc/flash_stats.cu",
        "fastdnn_tpu/ops/pallas_kernels.py:814, :853",
    ),
    "normalize_stats": Kernel(
        "fastdnn_tpu_torch/csrc/flash_stats.cu", "fastdnn_tpu/ops/pallas_kernels.py:572-585"
    ),
}

#: the lazy semantics as the resident-softmax kernels number them
_SEMANTICS = {"reference": 0, "active_only": 1}

_count_lock = threading.Lock()
_counts = dict.fromkeys(KERNELS, 0)


def launch_counts() -> dict:
    """Kernel launches since the last `reset_launch_counts`, by wrapper."""
    with _count_lock:
        return dict(_counts)


def reset_launch_counts() -> None:
    with _count_lock:
        for name in _counts:
            _counts[name] = 0


def kernel_layout(w: torch.Tensor) -> torch.Tensor:
    """int8 weights [..., K, N] -> the kernels' layout [..., N, K], contiguous."""
    return w.transpose(-1, -2).contiguous()


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest TF32 value (10 explicit mantissa bits, ties away
    from zero), as f32 with its 13 low mantissa bits zero: what
    `cvt.rna.tf32.f32` gives."""
    bits = x.contiguous().view(torch.int32)
    # adding half a TF32 step to the magnitude bits and cutting rounds half
    # away from zero, carrying into the exponent where it must
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def input_layer_operand(w: torch.Tensor) -> torch.Tensor:
    """K9's weight operand: f32 w [K, H] -> f32 [2, H, K4] with W_hi =
    tf32_round(w) and W_lo = tf32_round(w - W_hi), each transposed (K
    contiguous) and zero-padded to K4, K rounded up to INPUT_K_MULTIPLE."""
    k = w.shape[0]
    wt = w.t().to(torch.float32)
    wt = torch.nn.functional.pad(wt, (0, -k % INPUT_K_MULTIPLE))
    hi = tf32_round(wt)
    return torch.stack([hi, tf32_round(wt - hi)])


def _launch(name: str, device: torch.device, fn, *args) -> None:
    """Run one C entry on `device`'s current stream, raise on a non-zero
    status, count the launch."""
    stream = torch.cuda.current_stream(device).cuda_stream
    status = fn(*args, device.index, stream)
    if status != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed with cudaError {status}")
    with _count_lock:
        _counts[name] += 1


def _check(name, tensors, dtypes, shapes, *, cuda: bool = True) -> torch.device:
    """All tensors on one device (a CUDA one unless `cuda` is False), of the
    given dtypes and shapes (None in a shape matches any size), and
    contiguous on the card."""
    device = tensors[0].device
    for t, dtype, shape in zip(tensors, dtypes, shapes):
        if t.device != device or (cuda and t.device.type != "cuda"):
            raise ValueError(f"{name}: every tensor must be on one {'CUDA ' if cuda else ''}"
                             f"device, got {t.device}")
        if t.dtype != dtype:
            raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
        if t.dim() != len(shape) or any(s is not None and s != d for s, d in zip(shape, t.shape)):
            raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
        if t.device.type == "cuda" and not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    return device


def _require_multiples(name: str, **dims) -> None:
    bad = [f"{k}={v} (multiple of {m})" for k, (v, m) in dims.items() if v % m]
    if bad:
        raise ValueError(
            f"{name}: padded shapes required: {', '.join(bad)}; "
            "use quant.quantize.pad_qnet and frame bucketing"
        )


def _require_smem(name: str, device: torch.device, need: int) -> None:
    limit = getattr(
        torch.cuda.get_device_properties(device), "shared_memory_per_block_optin",
        HOPPER_BLOCK_SMEM,
    )
    if need > limit:
        raise ValueError(
            f"{name}: needs {need} bytes of shared memory per block, the card allows {limit}"
        )


def wgmma_cluster(frames: int) -> int:
    """Blocks per cluster of a wgmma launch over `frames` rows: WGMMA_CLUSTER,
    or 1 when the batch has an odd number of 64-frame blocks."""
    return WGMMA_CLUSTER if (frames // HIDDEN_STACK_FRAMES) % WGMMA_CLUSTER == 0 else 1


def _check_tma_weight(name: str, w_t: torch.Tensor, what: str = "the weight") -> None:
    """The wgmma kernels read the weight (K2, K7: and the activations) by
    TMA, from a 16-byte boundary."""
    if w_t.data_ptr() % 16:
        raise ValueError(f"{name}: {what} must start on a 16-byte boundary")


def bias_sigmoid_i8(lin: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """K1: quantized_sigmoid_shifted_i8(lin + bias), f32 [B, N], [N] -> s8 [B, N].
    Plain version: ops.matmul.bias_sigmoid_i8."""
    if lin.device.type == "cpu":
        return plain.bias_sigmoid_i8(lin, bias)
    n = lin.shape[-1] if lin.dim() == 2 else -1
    device = _check("bias_sigmoid_i8", (lin, bias), (torch.float32,) * 2, ((None, None), (n,)))
    out = torch.empty(lin.shape, dtype=torch.int8, device=device)
    if lin.numel():
        lib = _build.load()
        _launch("bias_sigmoid_i8", device, lib.fdn_bias_sigmoid_i8,
                lin.data_ptr(), bias.data_ptr(), out.data_ptr(), lin.numel(), n)
    return out


def input_layer(frames, w, operand, bias) -> torch.Tensor:
    """K9: quantized_sigmoid_shifted_i8(f32(frames @ w) + bias), f32 [B, K]
    x f32 [K, H] -> shifted s8 [B, H], in one launch; the kernel reads the
    weight as operand = input_layer_operand(w), [2, H, K4].  Frames whose K
    is not a multiple of INPUT_K_MULTIPLE (or that start off a 16-byte
    boundary) are copied, zero-padded, first.  Within 1 count, on at most
    1e-4 of the entries, of its plain version, ops.matmul.input_layer_step
    (the f64 product rounded once to f32)."""
    if frames.device.type == "cpu":
        return plain.input_layer_step(frames, w, bias)
    b, k = frames.shape
    h = w.shape[1]
    k4 = k + -k % INPUT_K_MULTIPLE
    device = _check(
        "input_layer", (frames, w, operand, bias), (torch.float32,) * 4,
        ((b, k), (k, h), (2, h, k4), (h,)),
    )
    _require_multiples("input_layer", H=(h, TILE_N))
    _check_tma_weight("input_layer", operand, "the operand")
    if k4 != k:
        frames = torch.nn.functional.pad(frames, (0, k4 - k))
    elif frames.data_ptr() % 16:
        frames = frames.clone()
    out = torch.empty((b, h), dtype=torch.int8, device=device)
    if b:
        lib = _build.load()
        _require_smem("input_layer", device, lib.fdn_input_layer_smem_bytes())
        _launch("input_layer", device, lib.fdn_input_layer,
                frames.data_ptr(), operand.data_ptr(), bias.data_ptr(), out.data_ptr(), b, k4, h)
    return out


def hidden_layer(acts, w_t, colsum, inv_scale: float, bias) -> torch.Tensor:
    """K2: one hidden layer, s8 [B, K] x s8 [K, N] -> shifted s8 [B, N];
    the weight given as w_t = kernel_layout(w), [N, K].  Plain version:
    ops.matmul.hidden_layer_step."""
    if acts.device.type == "cpu":
        return plain.hidden_layer_step(acts, w_t.t(), colsum, inv_scale, bias)
    b, k = acts.shape
    n = w_t.shape[0]
    device = _check(
        "hidden_layer", (acts, w_t, colsum, bias),
        (torch.int8, torch.int8, torch.int32, torch.float32),
        ((b, k), (n, k), (n,), (n,)),
    )
    _require_multiples("hidden_layer", B=(b, HIDDEN_LAYER_FRAMES), K=(k, TILE_K), N=(n, TILE_N))
    _check_tma_weight("hidden_layer", w_t)
    _check_tma_weight("hidden_layer", acts, "the activations")
    out = torch.empty((b, n), dtype=torch.int8, device=device)
    if b:
        lib = _build.load()
        _require_smem("hidden_layer", device, lib.fdn_hidden_layer_smem_bytes())
        _launch("hidden_layer", device, lib.fdn_hidden_layer,
                acts.data_ptr(), w_t.data_ptr(), colsum.data_ptr(), bias.data_ptr(),
                float(inv_scale), out.data_ptr(), b, k, n, wgmma_cluster(b))
    return out


def hidden_layer_packed(acts, w_t, colsum, inv_scale: float, bias) -> torch.Tensor:
    """K7: one int4 hidden layer stored two nibbles per byte, s8 [B, K] x
    packed s8 [K/2, N] -> shifted s8 [B, N]; the weight given as
    w_t = kernel_layout(packed), [N, K/2].  Bitwise equal to K2 on the same
    int4 values held unpacked.  Plain version:
    ops.matmul.hidden_layer_step_packed."""
    if acts.device.type == "cpu":
        return plain.hidden_layer_step_packed(acts, w_t.t(), colsum, inv_scale, bias)
    b, k = acts.shape
    n = w_t.shape[0]
    device = _check(
        "hidden_layer_packed", (acts, w_t, colsum, bias),
        (torch.int8, torch.int8, torch.int32, torch.float32),
        ((b, k), (n, k // 2), (n,), (n,)),
    )
    _require_multiples("hidden_layer_packed", B=(b, HIDDEN_LAYER_FRAMES), K=(k, TILE_K),
                       N=(n, TILE_N))
    _check_tma_weight("hidden_layer_packed", w_t)
    _check_tma_weight("hidden_layer_packed", acts, "the activations")
    out = torch.empty((b, n), dtype=torch.int8, device=device)
    if b:
        lib = _build.load()
        _require_smem("hidden_layer_packed", device, lib.fdn_hidden_layer_packed_smem_bytes())
        _launch("hidden_layer_packed", device, lib.fdn_hidden_layer_packed,
                acts.data_ptr(), w_t.data_ptr(), colsum.data_ptr(), bias.data_ptr(),
                float(inv_scale), out.data_ptr(), b, k, n, wgmma_cluster(b))
    return out


def hidden_stack(acts, w_t, colsum, inv_scales, bias) -> torch.Tensor:
    """K3: L square hidden layers in one launch, s8 [B, H] -> s8 [B, H].
    w_t s8 [L, H, H] (each layer in kernel_layout), colsum i32 [L, H],
    inv_scales f32 [L], bias f32 [L, H].  Plain version:
    ops.matmul.hidden_stack_step."""
    if acts.device.type == "cpu":
        return plain.hidden_stack_step(acts, (w_t.transpose(1, 2), colsum, inv_scales, bias))
    b, h = acts.shape
    layers = w_t.shape[0] if w_t.dim() == 3 else -1
    device = _check(
        "hidden_stack", (acts, w_t, colsum, inv_scales, bias),
        (torch.int8, torch.int8, torch.int32, torch.float32, torch.float32),
        ((b, h), (layers, h, h), (layers, h), (layers,), (layers, h)),
    )
    _require_multiples("hidden_stack", B=(b, HIDDEN_STACK_FRAMES), H=(h, TILE_N))
    _check_tma_weight("hidden_stack", w_t)
    out = torch.empty((b, h), dtype=torch.int8, device=device)
    if b:
        lib = _build.load()
        _require_smem("hidden_stack", device, lib.fdn_hidden_stack_wgmma_smem_bytes(h))
        _launch("hidden_stack", device, lib.fdn_hidden_stack_wgmma,
                acts.data_ptr(), w_t.data_ptr(), colsum.data_ptr(), inv_scales.data_ptr(),
                bias.data_ptr(), out.data_ptr(), b, h, layers, wgmma_cluster(b))
    return out


def _output_layer_shapes(name, acts, w_t, colsum, bias, masks, frames) -> torch.device:
    """Check the output kernels' operands (masks may be None) and their
    tile multiples; returns their device."""
    b, k = acts.shape
    n = w_t.shape[0]
    tensors = [acts, w_t, colsum, bias]
    dtypes = [torch.int8, torch.int8, torch.int32, torch.float32]
    shapes = [(b, k), (n, k), (n,), (n,)]
    if masks is not None:
        tensors.append(masks)
        dtypes.append(torch.uint8)
        shapes.append((b, n))
    device = _check(name, tensors, dtypes, shapes)
    _require_multiples(name, B=(b, frames), K=(k, TILE_K), N=(n, TILE_N))
    if masks is not None and masks.data_ptr() % 16:
        raise ValueError(f"{name}: masks must start on a 16-byte boundary")
    return device


def _resident_args(name, acts, w_t, colsum, bias, masks, out_dim, semantics):
    """Shared checks of K4 and K6 -> (device, semantics code)."""
    device = _output_layer_shapes(name, acts, w_t, colsum, bias, masks, RESIDENT_SOFTMAX_FRAMES)
    n = w_t.shape[0]
    if not 0 < out_dim <= n:
        raise ValueError(f"{name}: out_dim={out_dim} must be in [1, {n}]")
    if semantics not in _SEMANTICS:
        raise ValueError(f"{name}: unknown lazy semantics {semantics!r}")
    return device, _SEMANTICS[semantics]


def resident_softmax(acts, w_t, colsum, inv_scale: float, bias, masks=None, *, out_dim: int,
                     semantics: str = "reference", fast: bool = False) -> torch.Tensor:
    """K4: output layer + row softmax over the first `out_dim` columns,
    s8 [B, K] x s8 [K, N] -> [B, out_dim], f32 or (fast) bf16; the weight
    given as w_t = kernel_layout(w), [N, K].  masks: None or u8 [B, N],
    softmax under `semantics` ("reference" or "active_only").  Plain
    version: ops.matmul.output_posteriors."""
    if acts.device.type == "cpu":
        return plain.output_posteriors(acts, w_t.t(), colsum, inv_scale, bias, masks,
                                       out_dim=out_dim, semantics=semantics, fast=fast)
    device, code = _resident_args("resident_softmax", acts, w_t, colsum, bias, masks, out_dim,
                                  semantics)
    b, k = acts.shape
    out = torch.empty((b, out_dim), dtype=torch.bfloat16 if fast else torch.float32,
                      device=device)
    # bf16 posteriors cannot hold the logits between the kernel's two sweeps
    logits = torch.empty((b, out_dim), dtype=torch.float32, device=device) if fast else out
    _check_tma_weight("resident_softmax", w_t)
    if b:
        lib = _build.load()
        _require_smem("resident_softmax", device, lib.fdn_resident_softmax_wgmma_smem_bytes(k))
        _launch("resident_softmax", device, lib.fdn_resident_softmax_wgmma,
                acts.data_ptr(), w_t.data_ptr(), colsum.data_ptr(), bias.data_ptr(),
                float(inv_scale), None if masks is None else masks.data_ptr(), code,
                logits.data_ptr(), out.data_ptr(), int(fast), b, k, w_t.shape[0], out_dim)
    return out


def resident_softmax_block_sparse(acts, w_t, colsum, inv_scale: float, bias, masks, *,
                                  out_dim: int, semantics: str = "reference") -> torch.Tensor:
    """K6: K4 masked, skipping the weight loads and products of every
    (64-frame x 128-column) tile whose mask is all zero -> f32 [B, out_dim];
    N at most 65,536.  Plain version: ops.matmul.output_posteriors_block_sparse."""
    if acts.device.type == "cpu":
        return plain.output_posteriors_block_sparse(acts, w_t.t(), colsum, inv_scale, bias, masks,
                                                    out_dim=out_dim, semantics=semantics)
    device, code = _resident_args("resident_softmax_block_sparse", acts, w_t, colsum, bias, masks,
                                  out_dim, semantics)
    b, k = acts.shape
    _check_tma_weight("resident_softmax_block_sparse", w_t)
    out = torch.empty((b, out_dim), dtype=torch.float32, device=device)
    if b:
        lib = _build.load()
        _require_smem("resident_softmax_block_sparse", device,
                      lib.fdn_resident_softmax_block_sparse_smem_bytes(k))
        _launch("resident_softmax_block_sparse", device, lib.fdn_resident_softmax_block_sparse,
                acts.data_ptr(), w_t.data_ptr(), colsum.data_ptr(), bias.data_ptr(),
                float(inv_scale), masks.data_ptr(), code, out.data_ptr(), b, k, w_t.shape[0],
                out_dim)
    return out


def block_skip_share(masks: torch.Tensor) -> float:
    """Share of K6's (64-frame x 128-column) tiles that `masks` [B, N]
    leaves all-inactive, i.e. the tiles K6 skips."""
    active = plain.block_activity(masks, RESIDENT_SOFTMAX_FRAMES, TILE_N)
    return float(active.logical_not().float().mean())


def output_logits(acts, w_t, colsum, inv_scale: float, bias) -> torch.Tensor:
    """K5: output-layer logits, s8 [B, K] x s8 [K, N] -> f32 [B, N]; the
    weight given as w_t = kernel_layout(w), [N, K].  K2's kernel with an f32
    epilogue.  Plain version: ops.matmul.output_logits."""
    if acts.device.type == "cpu":
        return plain.output_logits(acts, w_t.t(), colsum, inv_scale, bias)
    device = _output_layer_shapes("output_logits", acts, w_t, colsum, bias, None,
                                  OUTPUT_LOGITS_FRAMES)
    b, k = acts.shape
    n = w_t.shape[0]
    _check_tma_weight("output_logits", w_t)
    _check_tma_weight("output_logits", acts, "the activations")
    out = torch.empty((b, n), dtype=torch.float32, device=device)
    if b:
        lib = _build.load()
        _require_smem("output_logits", device, lib.fdn_output_logits_smem_bytes())
        _launch("output_logits", device, lib.fdn_output_logits,
                acts.data_ptr(), w_t.data_ptr(), colsum.data_ptr(), bias.data_ptr(),
                float(inv_scale), out.data_ptr(), b, k, n, wgmma_cluster(b))
    return out


def _stats_args(name, acts, w_t, colsum, bias, masks, valid_count, semantics):
    """Shared checks of the flash-stats wrappers -> (device, semantics code)."""
    device = _output_layer_shapes(name, acts, w_t, colsum, bias, masks, FLASH_STATS_FRAMES)
    n = w_t.shape[0]
    if not 0 <= valid_count <= n:
        raise ValueError(f"{name}: valid_count={valid_count} must be in [0, {n}]")
    if semantics not in _SEMANTICS:
        raise ValueError(f"{name}: unknown lazy semantics {semantics!r}")
    _check_tma_weight(name, w_t)
    _check_tma_weight(name, acts, "the activations")
    return device, _SEMANTICS[semantics]


def _stats_outputs(b, n, device, fast):
    """Fresh (z, m, s, tile_max) for a flash-stats launch; tile_max only
    with `fast`."""
    z = torch.empty((b, n), dtype=torch.bfloat16 if fast else torch.float32, device=device)
    m = torch.empty((b, 1), dtype=torch.float32, device=device)
    s = torch.empty((b, 1), dtype=torch.float32, device=device)
    tile_max = torch.empty((b, n // TILE_N), dtype=torch.float32, device=device) if fast else None
    return z, m, s, tile_max


def flash_stats(acts, w_t, colsum, inv_scale: float, bias, masks=None, *, valid_count: int,
                semantics: str = "reference", fast: bool = False):
    """K8: output logits and their softmax row stats, s8 [B, K] x s8 [K, N]
    -> (z f32 [B, N], m f32 [B, 1], s f32 [B, 1]), the weight given as
    w_t = kernel_layout(w), [N, K].  masks: None or u8 [B, N] under
    `semantics`; columns at or beyond `valid_count` are capped at -1e30.
    `fast` -> (z_rel bf16 [B, N], m, s, tile_max f32 [B, N / 128]).  No limit
    on K: the activations stream with the weight stages.  Plain version:
    ops.matmul.flash_stats."""
    if acts.device.type == "cpu":
        return plain.flash_stats(acts, w_t.t(), colsum, inv_scale, bias, masks,
                                 valid_count=valid_count, semantics=semantics, fast=fast)
    device, code = _stats_args("flash_stats", acts, w_t, colsum, bias, masks, valid_count,
                               semantics)
    b, k = acts.shape
    n = w_t.shape[0]
    z, m, s, tile_max = _stats_outputs(b, n, device, fast)
    if b:
        lib = _build.load()
        _require_smem("flash_stats", device, lib.fdn_flash_stats_smem_bytes(0))
        _launch("flash_stats", device, lib.fdn_flash_stats,
                acts.data_ptr(), w_t.data_ptr(), colsum.data_ptr(), bias.data_ptr(),
                float(inv_scale), None if masks is None else masks.data_ptr(), code,
                int(valid_count), 0, 0, int(fast), z.data_ptr(), m.data_ptr(), s.data_ptr(),
                None if tile_max is None else tile_max.data_ptr(), b, k, n)
    return (z, m, s, tile_max) if fast else (z, m, s)


def flash_stats_block_sparse(acts, w_t, colsum, inv_scale: float, bias, masks, *,
                             valid_count: int, semantics: str = "reference",
                             capped_fill: bool = False):
    """K8 masked, skipping the weight loads and products of every
    (64-frame x 128-column) tile whose mask is all zero -> (z f32 [B, N],
    m, s f32 [B, 1]).  A skipped tile stores the fill logit (with
    `capped_fill`, -1e30 at or beyond `valid_count`).  N at most
    FLASH_STATS_MAX_SKIP_N.  Plain version: ops.matmul.block_sparse_stats."""
    if acts.device.type == "cpu":
        return plain.block_sparse_stats(acts, w_t.t(), colsum, inv_scale, bias, masks,
                                        valid_count=valid_count, semantics=semantics,
                                        capped_fill=capped_fill)
    device, code = _stats_args("flash_stats_block_sparse", acts, w_t, colsum, bias, masks,
                               valid_count, semantics)
    b, k = acts.shape
    n = w_t.shape[0]
    if n > FLASH_STATS_MAX_SKIP_N:
        raise ValueError(f"flash_stats_block_sparse: N={n} exceeds {FLASH_STATS_MAX_SKIP_N}")
    z, m, s, _ = _stats_outputs(b, n, device, False)
    if b:
        lib = _build.load()
        _require_smem("flash_stats_block_sparse", device, lib.fdn_flash_stats_smem_bytes(1))
        _launch("flash_stats_block_sparse", device, lib.fdn_flash_stats,
                acts.data_ptr(), w_t.data_ptr(), colsum.data_ptr(), bias.data_ptr(),
                float(inv_scale), masks.data_ptr(), code, int(valid_count), 1,
                int(capped_fill), 0, z.data_ptr(), m.data_ptr(), s.data_ptr(), None, b, k, n)
    return z, m, s


def normalize_stats(z, m, s, *, out_dim: int, tile_max=None) -> torch.Tensor:
    """K8's normalize in one pass: exp(z - m) / max(s, tiny) over the first
    `out_dim` columns of z [B, N] -> [B, out_dim], rows whose max stayed at
    the cap (m <= -1e29: no active senone) all 0.  z f32 with m, s f32
    [B, 1] -> f32; with `tile_max` f32 [B, N / 128] (fast stats), z is the
    bf16 z_rel, rebuilt as z_rel + its tile's max, -> bf16.  Shapes and
    dtypes are checked on every device.  Plain version:
    ops.matmul.normalize_stats."""
    fast = tile_max is not None
    if z.dim() != 2:
        raise ValueError(f"normalize_stats: z must be [B, N], got {tuple(z.shape)}")
    b, n = z.shape
    on_card = z.device.type != "cpu"
    if fast or on_card:  # the kernel's tiles; the fast stats' tile maxes
        _require_multiples("normalize_stats", N=(n, TILE_N))
    tensors = [z, m, s] + ([tile_max] if fast else [])
    dtypes = [torch.bfloat16 if fast else torch.float32] + [torch.float32] * (len(tensors) - 1)
    device = _check("normalize_stats", tensors, dtypes, [(b, n), (b, 1), (b, 1), (b, n // TILE_N)],
                    cuda=on_card)
    if not 0 < out_dim <= n:
        raise ValueError(f"normalize_stats: out_dim={out_dim} must be in [1, {n}]")
    if not on_card:
        return plain.normalize_stats(z, m, s, out_dim=out_dim, tile_max=tile_max)
    out = torch.empty((b, out_dim), dtype=z.dtype, device=device)
    if b:
        lib = _build.load()
        _launch("normalize_stats", device, lib.fdn_normalize_stats,
                z.data_ptr(), m.data_ptr(), s.data_ptr(),
                None if tile_max is None else tile_max.data_ptr(), out.data_ptr(), b, n, out_dim)
    return out

"""Python wrappers of the port's hand-written Hopper kernels (csrc/*.cu).

Dispatch rule, with no fallback: a tensor on the CPU goes to the kernel's
plain PyTorch version (ops/matmul.py); a CUDA tensor goes to the kernel,
and a kernel that cannot build or launch raises.  Each wrapper checks
device, dtype, shape and contiguity (five leave a net's constant operands
to a check that engine.backend.Backend.prepare calls once a net:
lazy_output, called once a decoder frame, its output layer to
check_lazy_output_layer; K9 and its bf16 variant, the first launch of
every dense request, the input layer to check_input_layer; K10 and its
bottleneck, whose host time per call matched their device time, the
factors to check_lowrank_layer), allocates its output with
`torch.empty`, launches on the current stream of the tensor's device and
adds one to its launch count (`launch_counts`), which is how a run shows
that its main path went through the kernels.

The kernels read their int8 weights transposed, K contiguous ([N, K], or
[L, N, K] for the stack; `kernel_layout`), the K-major operand that TMA
copies and wgmma reads; the plain versions keep the JAX package's [K, N].
A wrapper given CPU tensors transposes back for its plain version.

    K1 bias_sigmoid_i8                the quantized-sigmoid epilogue as its own kernel
    K9 input_layer                    the float input layer: 3xTF32 product + K1's
                                      epilogue, frames f32 in, s8 out (input
                                      precision "high" and "highest")
       input_layer_bf16               K9 with a 1-pass bf16 product (input
                                      precision "default")
    K2 hidden_layer                   one int8 hidden layer with the fused epilogue
                                      (activations streamed: any K)
    K3 hidden_stack                   all equal-width hidden layers in one launch
    K4 resident_softmax               int8 output layer + full row softmax, optionally
                                      masked (both lazy semantics) and bf16; at a
                                      short K two passes over the products in place
                                      of the logits' round trip (_recomputes)
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
       lazy_output                    a few rows' masked posteriors in one launch:
                                      the active senones' logits only, folded
                                      into each row's (max, sum-exp)
    K10 lowrank_layer                 one low-rank hidden layer (models.feedforward.
                                      LowRank): the bottleneck product, its signed
                                      codes with a scale per frame, the expand
                                      product and the sigmoid, in one launch
        lowrank_bottleneck            K10's first half for a low-rank output layer:
                                      the codes and each frame's scale, which K4
                                      and lazy_output take as a per-row scale
       tdnnf_input                    the TDNN-F chain net's tdnn1: the f32 product
                                      taken in f64 in the order of k (CUDA cores),
                                      ReLU, batchnorm, signed codes with a scale per
                                      row
    K11 tdnnf_project                 a TDNN-F layer's linear part: one product per
        chain_project                 time offset on signed codes, their rows read
                                      through a row map and offset; the codes of
                                      the sum (chain_: prefinal-l and prefinal-
                                      chain's second linear)
    K12 tdnnf_expand                  its affine part: the products, ReLU, batch-
        chain_expand                  norm, the bypass, the codes; two passes over
                                      the columns (chain_: prefinal-chain's affine)
    K13 chain_logits                  the chain output, f32 logits with a per-row
                                      scale, no softmax

Masks are uint8 [B, N] at the tile-padded output width, nonzero = active.

Every int8, TF32 and bf16 product runs Hopper's wgmma (csrc/hopper.cuh),
all but K11-K13's in its warp-specialised shape (TMA stages); K11-K13
(csrc/tdnnf.cu), whose row maps no tensor map describes, stage their
operands in the same swizzle by cp.async, one warpgroup a block, a first
design; `tdnnf_input` sums its f64 terms on CUDA cores.  K2, K3, K5 and K7 run blocks of 64 frames in
clusters of wgmma_cluster(B) blocks that share weight stages by multicast
(K2 and K5 are one kernel with two epilogues); K4, K6 and K8 run clusters
of 2 blocks that share 64 frames and split the output columns.  K9 takes
128 frames per block.  lazy_output needs no tensor core: one cluster of 16
blocks per row reads the active senones' weight rows, a warp per senone.

K9 reads the input weight as `input_layer_operand(w)`: W transposed and
split into two TF32 halves; its bf16 variant as `input_layer_operand(w,
"default")`: W transposed and rounded to bf16.  Either is made once, for
the configured precision (engine.backend.Backend.prepare).
"""

from __future__ import annotations

import functools
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
#: the widest output-layer input at which K4 runs its products twice (row
#: stats, then the posteriors) in place of a round trip of its f32 logits
#: through device memory: a second pass costs 2 K int8 operations an output,
#: the round trip 8 bytes.  Both paths timed in turns on an H100 at B =
#: 8192, N = 6016 / 8064, queued (chip_smoke.py phase 33, PERF.md): the two
#: passes 0.187 / 0.248 ms against 0.414 / 0.540 at K = 256, 0.280 / 0.366
#: against 0.431 / 0.557 at 512, 0.431 / 0.570 against 0.454 / 0.597 at
#: 1024, and 0.758 / 1.017 against 0.517 / 0.679 at 2048
RESIDENT_RECOMPUTE_MAX_K = 1024
#: the widest hidden layer K3 takes, for the same reason with 5 stages and
#: the sigmoid table (fdn_hidden_stack_wgmma_smem_bytes(2304) = 231,779
#: bytes); wider runs K2 per layer
HIDDEN_STACK_MAX_H = 2304
#: K9 reads frame and weight rows by TMA, whose rows start on 16-byte
#: boundaries: the operand's K is padded to a multiple of 4 f32
INPUT_K_MULTIPLE = 4
#: the bf16 operand's K is padded to a multiple of one bf16 wgmma step
INPUT_BF16_K_MULTIPLE = 16
#: the frame tile of K10 and its bottleneck, and the largest rank they hold
#: (one 128-column tile of the bottleneck per consumer warpgroup)
LOWRANK_FRAMES = 64
LOWRANK_MAX_RANK = 256
#: K11's N (a TDNN-F layer's linear part: wgmma n128 + n32), chain_project's
#: (n256), and the widest K of K12 and K13 (csrc/tdnnf.cu)
TDNNF_BOTTLENECK = 160
CHAIN_WIDTH = 256
TDNNF_MAX_AFFINE_K = 256
#: the widest input tdnnf_input holds (its rows as f64 in shared memory)
TDNNF_MAX_INPUT_K = 256
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
    "input_layer_bf16": Kernel(
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
    "lazy_output": Kernel(
        "fastdnn_tpu_torch/csrc/lazy_output.cu",
        "fastdnn_tpu/ops/pallas_kernels.py:1104, fastdnn_tpu/ops/matmul.py:106, :118",
    ),
    # the JAX package has no low-rank layer: these replace no TPU kernel
    "lowrank_layer": Kernel("fastdnn_tpu_torch/csrc/lowrank_layer.cu", "none"),
    "lowrank_bottleneck": Kernel("fastdnn_tpu_torch/csrc/lowrank_layer.cu", "none"),
    # nor a net with time context
    "tdnnf_input": Kernel("fastdnn_tpu_torch/csrc/tdnnf.cu", "none"),
    "tdnnf_project": Kernel("fastdnn_tpu_torch/csrc/tdnnf.cu", "none"),
    "tdnnf_expand": Kernel("fastdnn_tpu_torch/csrc/tdnnf.cu", "none"),
    "chain_project": Kernel("fastdnn_tpu_torch/csrc/tdnnf.cu", "none"),
    "chain_expand": Kernel("fastdnn_tpu_torch/csrc/tdnnf.cu", "none"),
    "chain_logits": Kernel("fastdnn_tpu_torch/csrc/tdnnf.cu", "none"),
}

#: the lazy semantics as the resident-softmax kernels number them
_SEMANTICS = {"reference": 0, "active_only": 1}

_count_lock = threading.Lock()
_counts = dict.fromkeys(KERNELS, 0)
_paths = {"round_trip": 0, "recompute": 0}


def launch_counts() -> dict:
    """Kernel launches since the last `reset_launch_counts`, by wrapper."""
    with _count_lock:
        return dict(_counts)


def resident_paths() -> dict:
    """K4's launches since the last `reset_launch_counts`, by path:
    "recompute" (two passes over the products) or "round_trip" (the logits
    through device memory and back).  Each also counts once under
    "resident_softmax" in `launch_counts`; K6 has one path and counts in
    neither."""
    with _count_lock:
        return dict(_paths)


def reset_launch_counts() -> None:
    with _count_lock:
        for counts in (_counts, _paths):
            for name in counts:
                counts[name] = 0


def _recomputes(k: int) -> bool:
    """Does K4 at output-layer input width `k` run two passes over its
    products in place of the logits' round trip?  By K alone, for every
    variant (masked or not, bf16, a per-row scale)."""
    return k <= RESIDENT_RECOMPUTE_MAX_K


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


def input_layer_operand(w: torch.Tensor, precision: str = "high") -> torch.Tensor:
    """The input kernel's weight operand for an input precision.  "high"
    and "highest" (K9): f32 w [K, H] -> f32 [2, H, K4] with W_hi =
    tf32_round(w) and W_lo = tf32_round(w - W_hi), each transposed (K
    contiguous) and zero-padded to K4, K rounded up to INPUT_K_MULTIPLE.
    "default" (input_layer_bf16): -> bf16 [H, K16], w transposed, rounded
    to the nearest bf16 (ties to even) and zero-padded to K16, K rounded up
    to INPUT_BF16_K_MULTIPLE."""
    plain.check_input_precision(precision)
    k = w.shape[0]
    wt = w.t().to(torch.float32)
    if precision == "default":
        wt = torch.nn.functional.pad(wt, (0, -k % INPUT_BF16_K_MULTIPLE))
        return wt.to(torch.bfloat16).contiguous()
    wt = torch.nn.functional.pad(wt, (0, -k % INPUT_K_MULTIPLE))
    hi = tf32_round(wt)
    return torch.stack([hi, tf32_round(wt - hi)])


def _launch(name: str, device: torch.device, fn, *args) -> None:
    """Run one C entry on `device`'s current stream, raise on a non-zero
    status, count the launch."""
    # the raw handle of torch.cuda.current_stream(device), without building
    # a Stream object (about 5 us a call on the H100's host)
    stream = torch._C._cuda_getCurrentRawStream(device.index)
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


@functools.lru_cache(maxsize=None)
def _smem_limit(index: int) -> int:
    """The opt-in shared memory per block of CUDA device `index`, read once."""
    return getattr(torch.cuda.get_device_properties(index), "shared_memory_per_block_optin",
                   HOPPER_BLOCK_SMEM)


def _require_smem(name: str, device: torch.device, need: int) -> None:
    limit = _smem_limit(device.index)
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
    TMA, from a 16-byte boundary; K8 its zero-point sums and biases in
    16-byte copies too."""
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


def check_input_layer(w, operand, bias, precision: str = "high") -> None:
    """K9's checks of a net's constant input layer, or, for precision
    "default", its bf16 variant's: w f32 [K, H], operand =
    input_layer_operand(w, precision) and bias f32 [H] on one CUDA device,
    contiguous, H a multiple of 128, the operand on a 16-byte boundary, the
    block's shared memory.  engine.backend.Backend.prepare makes them once a
    net: made on every call they lay between a dense request's start and its
    first launch, a stretch of 82-93 us of host time on an H100's host
    (PERF.md).  CPU tensors need none."""
    if w.device.type == "cpu":
        return
    k, h = w.shape if w.dim() == 2 else (-1, -1)
    if precision == "default":
        name, dtype = "input_layer_bf16", torch.bfloat16
        shape = (h, k + -k % INPUT_BF16_K_MULTIPLE)
    else:
        name, dtype, shape = "input_layer", torch.float32, (2, h, k + -k % INPUT_K_MULTIPLE)
    device = _check(name, (w, operand, bias), (torch.float32, dtype, torch.float32),
                    ((k, h), shape, (h,)))
    _require_multiples(name, H=(h, TILE_N))
    _check_tma_weight(name, operand, "the operand")
    _require_smem(name, device, _build.load().fdn_input_layer_smem_bytes())


def _input_frames(name: str, frames, w, operand) -> torch.device:
    """A call's own checks of K9 and its bf16 variant: frames f32 [B, K]
    contiguous on the operand's CUDA device (the input layer as
    check_input_layer passed it)."""
    device = _check(name, (frames,), (torch.float32,), ((None, w.shape[0]),))
    if operand.device != device:
        raise ValueError(f"{name}: the operand is on {operand.device}, the frames on {device}")
    return device


def input_layer(frames, w, operand, bias) -> torch.Tensor:
    """K9: quantized_sigmoid_shifted_i8(f32(frames @ w) + bias), f32 [B, K]
    x f32 [K, H] -> shifted s8 [B, H], in one launch; the kernel reads the
    weight as operand = input_layer_operand(w), [2, H, K4].  Frames whose K
    is not a multiple of INPUT_K_MULTIPLE (or that start off a 16-byte
    boundary) are copied, zero-padded, first.  The input layer is taken as
    check_input_layer passed it; the frames are checked here.  Within 1
    count, on at most 1e-4 of the entries, of its plain version,
    ops.matmul.input_layer_step (the f64 product rounded once to f32)."""
    if frames.device.type == "cpu":
        return plain.input_layer_step(frames, w, bias)
    device = _input_frames("input_layer", frames, w, operand)
    frames = _tma_frames(frames)
    b, h = frames.shape[0], operand.shape[1]
    out = torch.empty((b, h), dtype=torch.int8, device=device)
    if b:
        _launch("input_layer", device, _build.load().fdn_input_layer,
                frames.data_ptr(), operand.data_ptr(), bias.data_ptr(), out.data_ptr(), b,
                operand.shape[2], h)
    return out


def _tma_frames(frames: torch.Tensor) -> torch.Tensor:
    """f32 frames [B, K] as the input kernels read them by TMA: rows of a
    multiple of INPUT_K_MULTIPLE f32 from a 16-byte boundary (a zero-padded
    or aligned copy when they are not)."""
    k = frames.shape[1]
    if k % INPUT_K_MULTIPLE:
        return torch.nn.functional.pad(frames, (0, -k % INPUT_K_MULTIPLE))
    return frames.clone() if frames.data_ptr() % 16 else frames


def input_layer_bf16(frames, w, operand, bias) -> torch.Tensor:
    """K9's 1-pass bf16 variant: quantized_sigmoid_shifted_i8(f32(bf16(frames)
    @ bf16(w)) + bias), f32 [B, K] x f32 [K, H] -> shifted s8 [B, H], in one
    launch; the kernel reads the weight as operand =
    input_layer_operand(w, "default"), bf16 [H, K16], and rounds the frames
    itself.  Frames are padded as for K9, and the input layer is taken as
    check_input_layer(..., "default") passed it.  Within 1 count, on at most
    1e-4 of the entries, of its plain version, ops.matmul.input_layer_step(...,
    "default") (the f64 product of the rounded operands rounded once to
    f32)."""
    if frames.device.type == "cpu":
        return plain.input_layer_step(frames, w, bias, "default")
    device = _input_frames("input_layer_bf16", frames, w, operand)
    frames = _tma_frames(frames)
    b, h = frames.shape[0], operand.shape[0]
    out = torch.empty((b, h), dtype=torch.int8, device=device)
    if b:
        _launch("input_layer_bf16", device, _build.load().fdn_input_layer_bf16,
                frames.data_ptr(), operand.data_ptr(), bias.data_ptr(), out.data_ptr(), b,
                frames.shape[1], h)
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
                     semantics: str = "reference", fast: bool = False,
                     row_scale=None) -> torch.Tensor:
    """K4: output layer + row softmax over the first `out_dim` columns,
    s8 [B, K] x s8 [K, N] -> [B, out_dim], f32 or (fast) bf16; the weight
    given as w_t = kernel_layout(w), [N, K].  masks: None or u8 [B, N],
    softmax under `semantics` ("reference" or "active_only").  row_scale:
    None, or f32 [B], each row's scale in place of inv_scale (K4's ROWSCALE
    variant, f32 only: a low-rank output layer on its bottleneck's codes).
    At K <= RESIDENT_RECOMPUTE_MAX_K the kernel runs its products twice in
    place of the logits' round trip (`_recomputes`), with the same
    posteriors, bitwise wherever they are not subnormal.  Plain version:
    ops.matmul.output_posteriors."""
    if acts.device.type == "cpu":
        return plain.output_posteriors(acts, w_t.t(), colsum, inv_scale, bias, masks,
                                       out_dim=out_dim, semantics=semantics, fast=fast,
                                       row_scale=row_scale)
    return _resident_launch(acts, w_t, colsum, inv_scale, bias, masks, out_dim=out_dim,
                            semantics=semantics, fast=fast, row_scale=row_scale,
                            recompute=_recomputes(acts.shape[-1]))


def _resident_launch(acts, w_t, colsum, inv_scale, bias, masks, *, out_dim, semantics, fast,
                     row_scale, recompute: bool) -> torch.Tensor:
    """K4 on the card on the path `recompute` names: resident_softmax passes
    `_recomputes(K)`; a comparison of the two paths passes either."""
    device, code = _resident_args("resident_softmax", acts, w_t, colsum, bias, masks, out_dim,
                                  semantics)
    b, k = acts.shape
    if row_scale is not None:
        if fast:
            raise ValueError("resident_softmax: a per-row scale has no bf16 variant")
        _check("resident_softmax", (acts, row_scale), (torch.int8, torch.float32), ((b, k), (b,)))
    _check_tma_weight("resident_softmax", w_t)
    out = torch.empty((b, out_dim), dtype=torch.bfloat16 if fast else torch.float32,
                      device=device)
    if not b:
        return out
    lib = _build.load()
    smem = (lib.fdn_resident_softmax_recompute_smem_bytes if recompute
            else lib.fdn_resident_softmax_wgmma_smem_bytes)
    _require_smem("resident_softmax", device, smem(k))
    mask_ptr = None if masks is None else masks.data_ptr()
    if row_scale is not None:
        _launch("resident_softmax", device, lib.fdn_resident_softmax_rowscale,
                acts.data_ptr(), w_t.data_ptr(), colsum.data_ptr(), bias.data_ptr(),
                row_scale.data_ptr(), mask_ptr, code, out.data_ptr(), int(recompute), b, k,
                w_t.shape[0], out_dim)
    else:
        # bf16 posteriors cannot hold the logits between the round trip's two sweeps
        logits = None
        if not recompute:
            logits = (torch.empty((b, out_dim), dtype=torch.float32, device=device) if fast
                      else out).data_ptr()
        _launch("resident_softmax", device, lib.fdn_resident_softmax_wgmma,
                acts.data_ptr(), w_t.data_ptr(), colsum.data_ptr(), bias.data_ptr(),
                float(inv_scale), mask_ptr, code, logits, out.data_ptr(), int(fast),
                int(recompute), b, k, w_t.shape[0], out_dim)
    with _count_lock:
        _paths["recompute" if recompute else "round_trip"] += 1
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
    _check_tma_weight("flash_stats", colsum, "the zero-point sums")
    _check_tma_weight("flash_stats", bias, "the bias")
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


def check_lazy_output_layer(w_t, colsum, bias) -> None:
    """lazy_output's checks of a net's constant output layer: dtypes, shapes
    and contiguity, K a multiple of 16, the weight on a 16-byte boundary,
    the shared memory of its full width.  engine.backend.Backend.prepare makes
    them once a net: made on every frame they cost more host time than the
    frame's kernel takes (15-19 us a call on an H100's host).  CPU tensors
    need none."""
    if w_t.device.type == "cpu":
        return
    n, k = w_t.shape if w_t.dim() == 2 else (-1, -1)
    device = _check("lazy_output", (w_t, colsum, bias), (torch.int8, torch.int32, torch.float32),
                    ((n, k), (n,), (n,)))
    _require_multiples("lazy_output", K=(k, 16))
    _check_tma_weight("lazy_output", w_t)
    _require_smem("lazy_output", device, _build.load().fdn_lazy_output_smem_bytes(k, n))


def lazy_output(acts, w_t, colsum, inv_scale: float, bias, masks, *, out_dim: int,
                semantics: str = "reference", logits: bool = False,
                row_scale=None) -> torch.Tensor:
    """Masked posteriors of a few rows in one launch: s8 [rows, K] x s8
    [K, N] under masks u8 [rows, W] (nonzero = active, W >= out_dim; only
    the first out_dim columns are read) -> f32 [rows, out_dim], the softmax
    of `semantics` over the first out_dim logits; the weight given as
    w_t = kernel_layout(w), [N, K].  Only the active senones' logits are
    computed, bitwise K5's; `logits` returns them (inactive 0) without the
    softmax.  One cluster per row, so the launch suits a few rows.  The
    output layer's tensors are taken as check_lazy_output_layer passed
    them; each call's own tensors are checked here.  row_scale: None, or f32
    [rows], each row's scale in place of inv_scale (the kernel's ROWSCALE
    variant).  Plain version: ops.matmul.output_logits followed by
    ops.matmul.masked_softmax."""
    if acts.device.type == "cpu":
        z = plain.output_logits(acts, w_t.t(), colsum, inv_scale, bias, row_scale)[:, :out_dim]
        active = masks[:, :out_dim] != 0
        return torch.where(active, z, 0.0) if logits else plain.masked_softmax(z, active, semantics)
    code = 2 if logits else _SEMANTICS.get(semantics)
    if code is None:
        raise ValueError(f"lazy_output: unknown lazy semantics {semantics!r}")
    rows = acts.shape[0] if acts.dim() == 2 else -1
    n, k = w_t.shape
    device = _check("lazy_output", (acts, masks), (torch.int8, torch.uint8),
                    ((rows, k), (rows, None)))
    if row_scale is not None:
        _check("lazy_output", (acts, row_scale), (torch.int8, torch.float32), ((rows, k), (rows,)))
    if w_t.device != device:
        raise ValueError(f"lazy_output: the weight is on {w_t.device}, the activations on {device}")
    if not 0 < out_dim <= min(n, masks.shape[1]):
        raise ValueError(f"lazy_output: out_dim={out_dim} must be in [1, {n}] and at most the "
                         f"masks' width {masks.shape[1]}")
    _check_tma_weight("lazy_output", acts, "the activations")
    out = torch.empty((rows, out_dim), dtype=torch.float32, device=device)
    if rows:
        _launch("lazy_output", device, _build.load().fdn_lazy_output,
                acts.data_ptr(), w_t.data_ptr(), colsum.data_ptr(), bias.data_ptr(),
                float(inv_scale), masks.data_ptr(), masks.shape[1], code, out.data_ptr(), rows,
                k, out_dim, None if row_scale is None else row_scale.data_ptr())
    return out


def check_lowrank_layer(p_t, p_colsum, e_t=None, bias=None) -> None:
    """K10's and the bottleneck's checks of a net's constant factors: the
    bottleneck p_t [k, K] with its colsum128 [k] and, for K10, the expand
    factor e_t [N, k] with the bias [N]: dtypes, shapes and contiguity, K
    and N multiples of 128, the rank a multiple of 128 and at most
    LOWRANK_MAX_RANK, 16-byte boundaries, the block's shared memory.
    engine.backend.Backend.prepare makes them once a net: made on every
    call they cost about as much host time as the layer's kernel takes (a
    K10 call's wrapper took ≈ 60 us on an H100's host, beside 60 us of
    device time).  CPU tensors need none."""
    if p_t.device.type == "cpu":
        return
    rank, k = p_t.shape if p_t.dim() == 2 else (-1, -1)
    tensors, dtypes, shapes = [p_t, p_colsum], [torch.int8, torch.int32], [(rank, k), (rank,)]
    n = e_t.shape[0] if e_t is not None and e_t.dim() == 2 else -1
    if e_t is not None:
        tensors += [e_t, bias]
        dtypes += [torch.int8, torch.float32]
        shapes += [(n, rank), (n,)]
    device = _check("lowrank_layer", tensors, dtypes, shapes)
    _require_multiples("lowrank_layer", K=(k, TILE_K), rank=(rank, TILE_N),
                       **({"N": (n, TILE_N)} if e_t is not None else {}))
    if rank > LOWRANK_MAX_RANK:
        raise ValueError(f"lowrank_layer: rank {rank} exceeds the {LOWRANK_MAX_RANK} the kernel "
                         "holds")
    for w in tensors[:: 2]:  # p_t, e_t
        _check_tma_weight("lowrank_layer", w)
    _require_smem("lowrank_layer", device, _build.load().fdn_lowrank_smem_bytes())


def _lowrank_acts(name, acts, p_t) -> torch.device:
    """A call's own checks of K10 and its bottleneck: the activations s8
    [B, K] on the factors' CUDA device, B a multiple of LOWRANK_FRAMES, from
    a 16-byte boundary (the factors as check_lowrank_layer passed them)."""
    device = _check(name, (acts,), (torch.int8,), ((None, p_t.shape[1]),))
    if p_t.device != device:
        raise ValueError(f"{name}: the factors are on {p_t.device}, the activations on {device}")
    _require_multiples(name, B=(acts.shape[0], LOWRANK_FRAMES))
    _check_tma_weight(name, acts, "the activations")
    return device


def lowrank_layer(acts, p_t, p_colsum, p_inv: float, e_t, e_colsum, e_inv: float,
                  bias) -> torch.Tensor:
    """K10: one low-rank hidden layer, s8 [B, K] -> shifted s8 [B, N]: the
    bottleneck s8 [K, k] (given as p_t = kernel_layout, [k, K]) with its
    colsum128 and 1 / (multiplier * 255), its signed codes with a scale per
    frame, the expand factor s8 [k, N] (e_t [N, k]) with 1 / multiplier, the
    bias and the quantized sigmoid, in one launch (the contract of
    quant/quantize.py).  The factors and bias are taken as
    check_lowrank_layer passed them; e_colsum, the expand factor's zero
    colsum128, only reaches the plain version.  Plain version:
    ops.matmul.lowrank_layer_step."""
    if acts.device.type == "cpu":
        return plain.lowrank_layer_step(acts, p_t.t(), p_colsum, p_inv, e_t.t(), e_colsum,
                                        e_inv, bias)
    device = _lowrank_acts("lowrank_layer", acts, p_t)
    b, n = acts.shape[0], e_t.shape[0]
    out = torch.empty((b, n), dtype=torch.int8, device=device)
    if b:
        _launch("lowrank_layer", device, _build.load().fdn_lowrank_layer,
                acts.data_ptr(), p_t.data_ptr(), p_colsum.data_ptr(), float(p_inv),
                e_t.data_ptr(), float(e_inv), bias.data_ptr(), out.data_ptr(), b,
                p_t.shape[1], p_t.shape[0], n, wgmma_cluster(b))
    return out


def lowrank_bottleneck(acts, p_t, p_colsum, p_inv: float, e_inv: float):
    """K10's first half, for a low-rank output layer: s8 [B, K] -> (codes
    s8 [B, k], scale f32 [B]), each row's scale already times e_inv, the
    expand factor's 1 / multiplier, as K4's and lazy_output's ROWSCALE
    variants take it.  The factor is taken as check_lowrank_layer passed
    it.  Plain version: ops.matmul.bottleneck_step."""
    if acts.device.type == "cpu":
        return plain.bottleneck_step(acts, p_t.t(), p_colsum, p_inv, e_inv)
    device = _lowrank_acts("lowrank_bottleneck", acts, p_t)
    b, rank = acts.shape[0], p_t.shape[0]
    codes = torch.empty((b, rank), dtype=torch.int8, device=device)
    scale = torch.empty((b,), dtype=torch.float32, device=device)
    if b:
        _launch("lowrank_bottleneck", device, _build.load().fdn_lowrank_bottleneck,
                acts.data_ptr(), p_t.data_ptr(), p_colsum.data_ptr(), float(p_inv), float(e_inv),
                codes.data_ptr(), scale.data_ptr(), b, p_t.shape[1], rank, wgmma_cluster(b))
    return codes, scale


# -- the TDNN-F chain net (models.tdnnf; quant.quantize's contract) ----------


def tdnnf_input(frames, w, bias, gamma, beta):
    """tdnn1 of the TDNN-F chain net, f32 [B, K] -> (codes s8 [B, H], scale
    f32 [B]) in one launch: requant(f32(f32(max(f32(y + bias), 0) * gamma)
    + beta)), y = f32(sum over k in order of f64(x_k) * f64(w_k)).  The
    weight f32 [K, H] (K at most 256), bias, gamma and beta are taken as
    check_tdnnf_input passed them.  Plain version:
    ops.matmul.tdnnf_input_step, bitwise."""
    if frames.device.type == "cpu":
        return plain.tdnnf_input_step(frames, w, bias, gamma, beta)
    b, k = frames.shape
    device = _check("tdnnf_input", (frames,), (torch.float32,), ((None, w.shape[0]),))
    h = w.shape[1]
    codes = torch.empty((b, h), dtype=torch.int8, device=device)
    scale = torch.empty((b,), dtype=torch.float32, device=device)
    if b:
        _launch("tdnnf_input", device, _build.load().fdn_tdnnf_input, frames.data_ptr(),
                w.data_ptr(), bias.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                codes.data_ptr(), scale.data_ptr(), b, k, h)
    return codes, scale


def check_tdnnf_input(w, bias, gamma, beta) -> None:
    """tdnnf_input's checks of a net's constant input layer once a net: the
    weight f32 [K, H] (K at most 256) with the bias, gamma and beta f32 [H]
    on one CUDA device, contiguous, and the block's shared memory.  CPU
    tensors need none."""
    if w.device.type == "cpu":
        return
    k, h = w.shape if w.dim() == 2 else (-1, -1)
    device = _check("tdnnf_input", (w, bias, gamma, beta), (torch.float32,) * 4,
                    ((k, h), (h,), (h,), (h,)))
    if not 0 < k <= TDNNF_MAX_INPUT_K:
        raise ValueError(f"tdnnf_input: K={k} must be in [1, {TDNNF_MAX_INPUT_K}]")
    _require_smem("tdnnf_input", device, _build.load().fdn_tdnnf_input_smem_bytes(k, h))


def check_tdnnf_matrix(name: str, w_t, vectors=(), *, k_multiple: int, n_multiple: int = 8,
                       max_k: int = 0, n_exact: int = 0) -> None:
    """The checks of a TDNN-F net's constant matrix in the kernels' layout
    [N, K] (and its f32 [N] vectors) once a net: dtypes, shapes, contiguity,
    16-byte boundaries, the kernels' multiples and limits.
    engine.backend.Backend.prepare makes them; a call checks its
    activations only.  CPU tensors need none."""
    if w_t.device.type == "cpu":
        return
    n, k = w_t.shape if w_t.dim() == 2 else (-1, -1)
    _check(name, (w_t, *vectors), (torch.int8,) + (torch.float32,) * len(vectors),
           ((n, k),) + ((n,),) * len(vectors))
    _require_multiples(name, K=(k, k_multiple), N=(n, n_multiple))
    if (max_k and k > max_k) or (n_exact and n != n_exact):
        raise ValueError(f"{name}: [{n}, {k}] is not a width the kernel takes (K <= "
                         f"{max_k or 'any'}, N {'= ' + str(n_exact) if n_exact else 'any'})")
    _check_tma_weight(name, w_t)
    for v in vectors:
        if v.data_ptr() % 8:
            raise ValueError(f"{name}: its vectors must start on an 8-byte boundary")


def _tdnnf_acts(name: str, codes, scale, k: int) -> torch.device:
    """A call's own checks of K11-K13: codes s8 [n, k] and scale f32 [n] on
    one CUDA device, contiguous, the codes from a 16-byte boundary."""
    device = _check(name, (codes, scale), (torch.int8, torch.float32),
                    ((None, k), (codes.shape[0],)))
    _check_tma_weight(name, codes, "the codes")
    return device


def _term_args(term) -> tuple:
    codes, scale, w_t, inv, offset = term
    return codes.data_ptr(), scale.data_ptr(), w_t.data_ptr(), float(inv), int(offset)


_NO_TERM = (None, None, None, 0.0, 0)


def _plain_terms(terms) -> list:
    """The terms as the plain versions take them: each weight [K, N]."""
    return [(c, s, w_t.t(), inv, o) for c, s, w_t, inv, o in terms]


def tdnnf_project(terms, n_out: int, row_map=plain.ROWS_IDENTITY, bias=None, *,
                  chain: bool = False):
    """K11 (tdnnf_project; chain_project with `chain`): requant(sum of the
    terms [+ bias]) -> (codes s8 [n_out, N], scale f32 [n_out]).  terms:
    one or two (codes s8 [n_in, K], scale f32 [n_in], w_t s8 [N, K] =
    kernel_layout(w), inv_scale, row offset), both on the same codes; each
    output row r reads row map(r) + offset of them (ops.matmul.ROWS_IDENTITY's
    form; codes 0 and scale 0 outside).  K a multiple of 128; N
    TDNNF_BOTTLENECK (chain: CHAIN_WIDTH, one term, `bias` f32 [N] or None;
    without chain no bias).  The matrices are taken
    as check_tdnnf_matrix passed them.  Plain version:
    ops.matmul.tdnnf_project_step."""
    codes, scale = terms[0][0], terms[0][1]
    if codes.device.type == "cpu":
        return plain.tdnnf_project_step(_plain_terms(terms), n_out, row_map, bias)
    name = "chain_project" if chain else "tdnnf_project"
    n_in, k = codes.shape
    device = _tdnnf_acts(name, codes, scale, k)
    n = terms[0][2].shape[0]
    out = torch.empty((n_out, n), dtype=torch.int8, device=device)
    out_scale = torch.empty((n_out,), dtype=torch.float32, device=device)
    second = _term_args(terms[1]) if len(terms) > 1 else _NO_TERM
    _launch(name, device, _build.load().fdn_tdnnf_project, *_term_args(terms[0]), *second,
            *row_map, n_in, None if bias is None else bias.data_ptr(), out.data_ptr(),
            out_scale.data_ptr(), n_out, k, n, int(chain))
    return out, out_scale


def tdnnf_expand(terms, n_out: int, row_map, bias, gamma, beta, bypass=None, *,
                 chain: bool = False):
    """K12 (tdnnf_expand; chain_expand with `chain`): x = f32(f32(max(u, 0)
    * gamma) + beta), u = sum of the terms + bias, plus, with bypass =
    (codes s8 [., N], scale f32, factor, row map), f32(f32(q * s) * factor)
    of the row the bypass map gives; -> requant(x), (codes s8 [n_out, N],
    scale f32 [n_out]).  Terms as tdnnf_project's; K a multiple of 32, at
    most TDNNF_MAX_AFFINE_K; N a multiple of 128.  Without chain the bypass
    is required, with it none and one term.  Plain version:
    ops.matmul.tdnnf_expand_step."""
    codes, scale = terms[0][0], terms[0][1]
    if codes.device.type == "cpu":
        return plain.tdnnf_expand_step(_plain_terms(terms), n_out, row_map, bias, gamma, beta,
                                       bypass)
    name = "chain_expand" if chain else "tdnnf_expand"
    n_in, k = codes.shape
    device = _tdnnf_acts(name, codes, scale, k)
    n = terms[0][2].shape[0]
    if bypass is not None:
        by_codes, by_scale, factor, by_map = bypass
        _tdnnf_acts(name, by_codes, by_scale, n)
        by = (by_codes.data_ptr(), by_scale.data_ptr(), float(factor), *by_map)
    else:
        by = (None, None, 0.0, *plain.ROWS_IDENTITY)
    out = torch.empty((n_out, n), dtype=torch.int8, device=device)
    out_scale = torch.empty((n_out,), dtype=torch.float32, device=device)
    second = _term_args(terms[1]) if len(terms) > 1 else _NO_TERM
    _launch(name, device, _build.load().fdn_tdnnf_expand, *_term_args(terms[0]), *second,
            *row_map, n_in, bias.data_ptr(), gamma.data_ptr(), beta.data_ptr(), *by,
            out.data_ptr(), out_scale.data_ptr(), n_out, k, n, int(chain))
    return out, out_scale


def chain_logits(codes, scale, w_t, inv_scale, bias) -> torch.Tensor:
    """K13: the chain output, f32(T(p, O) + o) -> f32 [B, N], no softmax:
    codes s8 [B, K] with their scale f32 [B], O given as w_t =
    kernel_layout(O), [N, K], and its bias f32 [N]; K a multiple of 32, at
    most TDNNF_MAX_AFFINE_K, N a multiple of 8.  Plain version:
    ops.matmul.chain_logits_step."""
    if codes.device.type == "cpu":
        return plain.chain_logits_step(codes, scale, w_t.t(), inv_scale, bias)
    b, k = codes.shape
    device = _tdnnf_acts("chain_logits", codes, scale, k)
    n = w_t.shape[0]
    out = torch.empty((b, n), dtype=torch.float32, device=device)
    _launch("chain_logits", device, _build.load().fdn_chain_logits, codes.data_ptr(),
            scale.data_ptr(), w_t.data_ptr(), float(inv_scale), bias.data_ptr(), out.data_ptr(),
            b, k, n)
    return out

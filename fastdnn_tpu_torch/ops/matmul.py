"""Plain PyTorch versions of the quantized engine's stages.

Each function computes what fastdnn_tpu/ops/matmul.py computes, in eager
PyTorch on any device.  They are the reference the port's CUDA kernels are
held to (ops/kernels.py), the path a CPU tensor takes, and the whole of
`backend="torch"`.  They share the JAX package's layouts: activations
[B, K] as zero-point-shifted int8, weights [K, N] int8, per-layer colsum128
int32 [N], bias f32 [N] and an f32 inverse scale.

engine/backend.py puts these and the kernels behind one set of step
names, so the scorer holds one backend or the other.
"""

from __future__ import annotations

import torch

from ..config import INPUT_PRECISIONS
from .sigmoid import _round_half_away, quantized_sigmoid_shifted_i8

#: the bottleneck codes' range, symmetric: [-CODE_MAX, CODE_MAX]
CODE_MAX = 127.0


def matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """f32 [B, K] @ f32 [K, N] -> f32, free of every TF32 switch.

    The product is taken in float64 and rounded once to f32.  TF32 and the
    reduced-precision f32 modes apply only to f32 products, so neither
    `torch.backends.cuda.matmul.allow_tf32` nor
    `torch.set_float32_matmul_precision` can reach it, and no process-wide
    switch is read or changed.  The result is at least as close to the exact
    sum as any f32 summation order; against XLA's f32 dot it differs only in
    the last bit of rare entries, as two f32 summation orders do.
    """
    return torch.matmul(a.to(torch.float64), b.to(torch.float64)).to(torch.float32)


def int8_matmul(a_i8: torch.Tensor, w_i8: torch.Tensor) -> torch.Tensor:
    """[B, K] int8 @ [K, N] int8 -> [B, N] int32, exact.

    `torch._int_mm` is exact (int32 accumulation); on CUDA it needs more than
    16 rows and K, N multiples of 8.  Otherwise the product runs in float64,
    which is exact too: |sum| <= K * 128 * 128 stays far below 2**53.  (Plain
    f32 is not exact: at K = 2048 a sum can exceed 2**24.)
    """
    b, k = a_i8.shape
    n = w_i8.shape[1]
    if a_i8.device.type == "cpu" or (b > 16 and k % 8 == 0 and n % 8 == 0):
        return torch._int_mm(a_i8.contiguous(), w_i8.contiguous())
    return torch.matmul(a_i8.to(torch.float64), w_i8.to(torch.float64)).to(torch.int32)


def bias_sigmoid_i8(lin_f32: torch.Tensor, bias_f32: torch.Tensor) -> torch.Tensor:
    """quantized_sigmoid_shifted_i8(lin + bias): the input layer's epilogue."""
    return quantized_sigmoid_shifted_i8(lin_f32 + bias_f32)


def check_input_precision(precision: str) -> None:
    """Raise ValueError unless `precision` is an input precision
    (config.INPUT_PRECISIONS)."""
    if precision not in INPUT_PRECISIONS:
        raise ValueError(
            f"input_precision={precision!r}: choose one of {', '.join(INPUT_PRECISIONS)}"
        )


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest bf16 value (ties to even), as f32."""
    return x.to(torch.bfloat16).to(torch.float32)


def input_layer_step(frames_f32, w_f32, b_f32, precision: str = "high"):
    """Float first layer -> shifted-int8 quantized sigmoid activations.

    The input layer is not quantized; the feature shift/scale is already
    fused into (w, b).  precision (config.EngineConfig.input_precision):
    "high" and "highest" take the f64 product rounded once to f32
    (matmul_f32); "default" rounds both operands to bf16 first, the 1-pass
    bf16 product, whose f32 sums then differ from any f32-accumulating
    kernel's only by summation order (a product of two bf16 is exact in
    f32).
    """
    check_input_precision(precision)
    if precision == "default":
        frames_f32, w_f32 = bf16_round(frames_f32), bf16_round(w_f32)
    return bias_sigmoid_i8(matmul_f32(frames_f32, w_f32), b_f32)


def dequantize(acc_i32, colsum128_i32, inv_scale, bias_f32):
    """(acc + colsum128) * inv_scale + bias, rounded after each op.

    acc is the s8 x s8 product of shifted activations; adding colsum128
    recovers the true uint8 x int8 sum.  `inv_scale` is a Python float or a
    0-d f32 tensor holding the f32 scale.
    """
    return (acc_i32 + colsum128_i32).to(torch.float32) * inv_scale + bias_f32


def hidden_layer_step(acts_i8, w_i8, colsum128_i32, inv_scale, bias_f32):
    """One quantized hidden layer: int8 product -> dequant -> bias ->
    quantized sigmoid -> shifted int8."""
    acc = int8_matmul(acts_i8, w_i8)
    return quantized_sigmoid_shifted_i8(dequantize(acc, colsum128_i32, inv_scale, bias_f32))


def bottleneck_step(acts_i8, w_i8, colsum128_i32, inv_scale, next_inv_scale):
    """A low-rank layer's first product, the bottleneck, as signed codes
    with a scale per frame (the contract of quant/quantize.py):
    z = f32(acc + colsum128) * inv_scale, s = max|z| / 127 per row, codes
    clip(round_half_away(z / s), -127, 127) (0 in a row whose s is 0), and
    each row's scale s * next_inv_scale, the expand factor's 1 / multiplier.
    -> (codes s8 [B, k], scale f32 [B]).  The plain version of the
    bottleneck kernel."""
    z = (int8_matmul(acts_i8, w_i8) + colsum128_i32).to(torch.float32) * inv_scale
    s = z.abs().amax(dim=1) / CODE_MAX
    live = s[:, None] > 0
    codes = torch.clamp(_round_half_away(z / torch.where(live, s[:, None], 1.0)),
                        -CODE_MAX, CODE_MAX)
    return torch.where(live, codes, 0.0).to(torch.int8), (s * next_inv_scale).to(torch.float32)


def lowrank_layer_step(acts_i8, w1_i8, colsum1, inv1, w2_i8, colsum2, inv2, bias_f32):
    """One low-rank hidden layer: the bottleneck's codes and scales
    (bottleneck_step), the expand product on them, each row dequantized with
    its own scale, then the quantized sigmoid -> shifted int8.  The plain
    version of the low-rank layer kernel (K10)."""
    codes, scale = bottleneck_step(acts_i8, w1_i8, colsum1, inv1, inv2)
    acc = int8_matmul(codes, w2_i8)
    return quantized_sigmoid_shifted_i8(dequantize(acc, colsum2, scale[:, None], bias_f32))


def unpack_int4_pair(packed_i8: torch.Tensor):
    """[K/2, N] two-nibbles-per-byte int8 -> (lo, hi) int8 weight halves,
    the inverse of quant.quantize.pack_int4_trunk: lo[k] is weight row k,
    hi[k] weight row K/2 + k.  The low nibble is sign-extended as
    ((v & 0xF) ^ 8) - 8; the high one by an arithmetic shift."""
    w32 = packed_i8.to(torch.int32)
    lo = (((w32 & 0xF) ^ 8) - 8).to(torch.int8)
    hi = (w32 >> 4).to(torch.int8)
    return lo, hi


def hidden_layer_step_packed(acts_i8, w_packed_i8, colsum128_i32, inv_scale, bias_f32):
    """hidden_layer_step for a pack_int4_trunk weight [K/2, N]: two exact
    s8 products over the activation halves, bitwise equal to the unpacked
    int4 layer.  The plain version of the packed hidden-layer kernel."""
    kk = w_packed_i8.shape[0]
    lo, hi = unpack_int4_pair(w_packed_i8)
    acc = int8_matmul(acts_i8[:, :kk], lo) + int8_matmul(acts_i8[:, kk:], hi)
    return quantized_sigmoid_shifted_i8(dequantize(acc, colsum128_i32, inv_scale, bias_f32))


def hidden_stack_step(acts_i8, hstack):
    """All hidden layers of a stack (engine.scorer.build_hidden_stack) in
    turn: the plain version of the one-launch stack kernel."""
    w, colsum, inv_scales, bias = hstack
    for i in range(w.shape[0]):
        acts_i8 = hidden_layer_step(acts_i8, w[i], colsum[i], inv_scales[i], bias[i])
    return acts_i8


def output_logits(acts_i8, w_i8, colsum128_i32, inv_scale, bias_f32, row_scale=None):
    """Output layer linear activations (pre-softmax), f32 [B, N]: the plain
    version of the logits kernel.  row_scale: None, or f32 [B], each row's
    scale in place of inv_scale (a low-rank output layer's expand product
    on the bottleneck's codes)."""
    if row_scale is not None:
        inv_scale = row_scale[:, None]
    return dequantize(int8_matmul(acts_i8, w_i8), colsum128_i32, inv_scale, bias_f32)


def masked_softmax_reference(logits, mask_bool):
    """Softmax with the reference's lazy semantics: inactive senones keep a
    zero logit and still add exp(0 - max) to the denominator (the zeros take
    part in the max)."""
    z = torch.where(mask_bool, logits, 0.0)
    m = z.amax(dim=-1, keepdim=True)
    e = torch.exp(z - m)
    return e / e.sum(dim=-1, keepdim=True)


def masked_softmax_active_only(logits, mask_bool):
    """Softmax renormalized over active senones only; inactive posteriors
    are exactly 0, and a frame with no active senone gives an all-zero row
    (the denominator is floored at `tiny`, so no NaN)."""
    finfo = torch.finfo(logits.dtype)
    z = torch.where(mask_bool, logits, finfo.min)
    m = z.amax(dim=-1, keepdim=True)
    e = torch.where(mask_bool, torch.exp(z - m), 0.0)
    s = e.sum(dim=-1, keepdim=True)
    return e / torch.clamp(s, min=finfo.tiny)


def masked_softmax(logits, mask_bool, semantics: str):
    """The lazy softmax of `semantics` ("reference" or "active_only")."""
    if semantics == "reference":
        return masked_softmax_reference(logits, mask_bool)
    if semantics == "active_only":
        return masked_softmax_active_only(logits, mask_bool)
    raise ValueError(f"unknown lazy semantics {semantics!r}")


def masked_output_step(
    acts_i8, w_i8, colsum128_i32, inv_scale, bias_f32, mask_bool, *, semantics: str = "reference"
):
    """Dense masked output scoring: the full output product, then the lazy
    softmax of `semantics` over the masked logits."""
    logits = output_logits(acts_i8, w_i8, colsum128_i32, inv_scale, bias_f32)
    return masked_softmax(logits, mask_bool, semantics)


def output_posteriors(
    acts_i8,
    w_i8,
    colsum128_i32,
    inv_scale,
    bias_f32,
    masks=None,
    *,
    out_dim: int,
    semantics: str = "reference",
    fast: bool = False,
    row_scale=None,
):
    """Output layer + stable row softmax over the first `out_dim` columns
    -> [B, out_dim]: the plain version of the resident softmax kernel.
    Columns past `out_dim` (tile padding) never join the softmax.

    masks: None, or [B, >= out_dim] with nonzero = active; the masked
    softmax follows `semantics` (masked_softmax).  `fast` returns bfloat16
    posteriors (the f32 result, rounded to nearest even).  row_scale: as
    output_logits (the kernel's ROWSCALE variant)."""
    z = output_logits(acts_i8, w_i8, colsum128_i32, inv_scale, bias_f32, row_scale)[:, :out_dim]
    if masks is None:
        m = z.amax(dim=1, keepdim=True)
        e = torch.exp(z - m)
        p = e / e.sum(dim=1, keepdim=True)
    else:
        p = masked_softmax(z, masks[:, :out_dim] != 0, semantics)
    return p.to(torch.bfloat16 if fast else torch.float32).contiguous()


def output_posteriors_block_sparse(
    acts_i8, w_i8, colsum128_i32, inv_scale, bias_f32, masks, *, out_dim: int,
    semantics: str = "reference",
):
    """The plain version of the block-sparse masked softmax kernel: the same
    function as the dense masked softmax (skipping all-inactive tiles is the
    kernel's way of computing it, not a different result)."""
    return output_posteriors(
        acts_i8, w_i8, colsum128_i32, inv_scale, bias_f32, masks, out_dim=out_dim,
        semantics=semantics,
    )


def block_activity(masks, frames: int, cols: int):
    """Which (frames x cols) tiles of masks [B, N] hold an active senone ->
    bool [B / frames, N / cols]: the tiles a block-sparse kernel computes
    (the rest it skips)."""
    b, n = masks.shape
    return (masks != 0).reshape(b // frames, frames, n // cols, cols).any(dim=3).any(dim=1)


# -- the stats output layer (flash_stats kernel) -----------------------------

#: a logit kept out of the softmax (padding, beyond the valid count, inactive
#: under active_only); a row max at or below EMPTY_ROW_MAX had no active senone
NEG_CAP = -1e30
EMPTY_ROW_MAX = -1e29
#: the stats kernel's (frames x columns) tile: its skip granularity and, with
#: `fast`, the span of each stored tile max
STATS_TILE_FRAMES = 64
STATS_TILE_N = 128


def _fill(semantics: str) -> float:
    """The logit of an inactive senone under `semantics`."""
    if semantics == "reference":
        return 0.0
    if semantics == "active_only":
        return NEG_CAP
    raise ValueError(f"unknown lazy semantics {semantics!r}")


def _capped_logits(acts_i8, w_i8, colsum128_i32, inv_scale, bias_f32, masks, valid_count,
                   semantics):
    """Output logits, masked under `semantics` (masks nonzero = active), with
    every column at or beyond `valid_count` at NEG_CAP."""
    z = output_logits(acts_i8, w_i8, colsum128_i32, inv_scale, bias_f32)
    if masks is not None:
        z = torch.where(masks != 0, z, _fill(semantics))
    col = torch.arange(z.shape[1], device=z.device)
    return torch.where(col < valid_count, z, NEG_CAP)


def flash_stats(acts_i8, w_i8, colsum128_i32, inv_scale, bias_f32, masks=None, *,
                valid_count: int, semantics: str = "reference", fast: bool = False):
    """Output logits z f32 [B, N] and their unnormalized softmax stats, the
    row max m and sum exp(z - m), f32 [B, 1]: the plain version of the
    flash-stats kernel (fastdnn_tpu/ops/pallas_kernels.py:
    output_layer_flash_stats, and the stats half of output_layer_posteriors).

    masks: None or [B, N], nonzero = active, applied under `semantics`;
    columns at or beyond `valid_count` are NEG_CAP and add exp(NEG_CAP - m)
    (0 unless the whole row is capped).  `fast` returns (z_rel, m, s,
    tile_max): z_rel bf16 [B, N] is z minus the max of its 128-column tile,
    rounded once, and tile_max f32 [B, ceil(N / 128)] holds those maxes; m
    and s come from the f32 z.  N need not be a multiple of 128: a ragged
    last tile is filled out with NEG_CAP columns, so its max is that of its
    real columns, and the fill is cut from z_rel.  K8 takes only multiples
    of 128, where there is no fill and the tiles are z's own."""
    z = _capped_logits(acts_i8, w_i8, colsum128_i32, inv_scale, bias_f32, masks, valid_count,
                       semantics)
    m = z.amax(dim=1, keepdim=True)
    s = torch.exp(z - m).sum(dim=1, keepdim=True)
    if not fast:
        return z, m, s
    b, n = z.shape
    fill = -n % STATS_TILE_N
    tiles = torch.nn.functional.pad(z, (0, fill), value=NEG_CAP).view(b, -1, STATS_TILE_N)
    tile_max = tiles.amax(dim=2)
    z_rel = (tiles - tile_max[:, :, None]).view(b, n + fill)[:, :n].to(torch.bfloat16)
    return z_rel, m, s, tile_max


def tile_activity(masks) -> torch.Tensor:
    """bool [B / 64, N / 128]: whether each (64-frame x 128-column) tile of
    masks [B, N] holds an active senone; the tiles the stats kernel runs."""
    b, n = masks.shape
    tiles = masks.reshape(b // STATS_TILE_FRAMES, STATS_TILE_FRAMES, n // STATS_TILE_N,
                          STATS_TILE_N)
    return (tiles != 0).any(dim=3).any(dim=1)


def block_sparse_stats(acts_i8, w_i8, colsum128_i32, inv_scale, bias_f32, masks, *,
                       valid_count: int, semantics: str = "reference",
                       capped_fill: bool = False):
    """flash_stats, masked, with every all-inactive (64 x 128) tile skipped:
    the plain version of the flash-stats kernel's skipping variant
    (pallas_kernels.py:output_flash_stats_block_sparse, and the stats half of
    output_layer_posteriors_block_sparse).

    A skipped tile holds the fill logit (0 under reference, NEG_CAP under
    active_only; with `capped_fill`, NEG_CAP at or beyond `valid_count` too).
    In the stats, its valid columns count as logit 0 under reference and it
    adds nothing under active_only, as the TPU kernel's (m = 0, s = nskip)
    start does.  B and N must be tile multiples."""
    fill = _fill(semantics)
    z = _capped_logits(acts_i8, w_i8, colsum128_i32, inv_scale, bias_f32, masks, valid_count,
                       semantics)
    active = tile_activity(masks)
    active = active.repeat_interleave(STATS_TILE_FRAMES, 0).repeat_interleave(STATS_TILE_N, 1)
    valid = torch.arange(z.shape[1], device=z.device) < valid_count
    skipped_stat = torch.where(valid & (semantics == "reference"), 0.0, float("-inf"))
    z_stats = torch.where(active, z, skipped_stat)
    m = z_stats.amax(dim=1, keepdim=True).clamp(min=NEG_CAP)
    s = torch.exp(z_stats - m).sum(dim=1, keepdim=True)
    stored_fill = torch.where(valid, fill, NEG_CAP) if capped_fill else fill
    return torch.where(active, z, stored_fill), m, s


def normalize_stats(z, m, s, *, out_dim=None, tile_max=None):
    """exp(z - m) / s over the first `out_dim` columns (all when None), with
    the rows whose max stayed at the cap (no active senone) as zeros: the
    normalize the JAX package ran in XLA after its stats kernels
    (pallas_kernels.py:571-584, 842-846; parallel/sharded.py:181-186).
    `tile_max` (fast stats, [B, ceil(N / 128)]) restores z from z_rel and
    returns bf16."""
    if out_dim is None:
        out_dim = z.shape[1]
    zc = z[:, :out_dim]
    if tile_max is not None:
        zc = zc.float() + tile_max.repeat_interleave(STATS_TILE_N, dim=1)[:, :out_dim]
    p = torch.exp(zc - m) / torch.clamp(s, min=torch.finfo(torch.float32).tiny)
    p = torch.where(m > EMPTY_ROW_MAX, p, 0.0)
    return p.to(torch.bfloat16) if tile_max is not None else p


def output_posteriors_stats(acts_i8, w_i8, colsum128_i32, inv_scale, bias_f32, masks=None, *,
                            out_dim: int, semantics: str = "reference", fast: bool = False):
    """Output layer + softmax through the stats -> [B, out_dim], f32 or
    (fast) bf16: the plain version of pallas_kernels.py:
    output_layer_posteriors, the route for an output layer too wide for the
    resident softmax kernel."""
    stats = flash_stats(acts_i8, w_i8, colsum128_i32, inv_scale, bias_f32, masks,
                        valid_count=out_dim, semantics=semantics, fast=fast)
    return normalize_stats(*stats[:3], out_dim=out_dim, tile_max=stats[3] if fast else None)


def output_posteriors_block_sparse_stats(acts_i8, w_i8, colsum128_i32, inv_scale, bias_f32,
                                         masks, *, out_dim: int, semantics: str = "reference"):
    """Masked output + softmax through the tile-skipping stats -> f32
    [B, out_dim]: the plain version of pallas_kernels.py:
    output_layer_posteriors_block_sparse."""
    z, m, s = block_sparse_stats(acts_i8, w_i8, colsum128_i32, inv_scale, bias_f32, masks,
                                 valid_count=out_dim, semantics=semantics)
    return normalize_stats(z, m, s, out_dim=out_dim)


# -- the TDNN-F chain net (models.tdnnf; quant.quantize's contract) ----------

#: a row map (per_out, per_in, first, step): output row r reads input row
#: r // per_out * per_in + first + r % per_out * step (then a term's offset)
ROWS_IDENTITY = (1, 1, 0, 0)


def requantize(v: torch.Tensor):
    """The contract's requant: f32 [B, N] -> (codes s8 [B, N], scale f32 [B]),
    s = max|v| / 127 per row, codes clip(round_half_away(v / s), -127, 127),
    0 in a row whose s is 0; each division a true f32 division."""
    amax = v.abs().amax(dim=1)
    s = amax / torch.full_like(amax, CODE_MAX)
    live = s[:, None] > 0
    codes = torch.clamp(_round_half_away(v / torch.where(live, s[:, None], 1.0)),
                        -CODE_MAX, CODE_MAX)
    return torch.where(live, codes, 0.0).to(torch.int8), s


def tdnnf_rows(n_out: int, row_map, offset: int, n_in: int, device):
    """(index, valid) of the input rows that output rows 0 .. n_out - 1 read
    under `row_map` and `offset`; a row outside [0, n_in) is not valid (its
    index clamped in range)."""
    per_out, per_in, first, step = row_map
    r = torch.arange(n_out, device=device)
    idx = r // per_out * per_in + first + r % per_out * step + offset
    valid = (idx >= 0) & (idx < n_in)
    return idx.clamp(0, max(n_in - 1, 0)), valid


def tdnnf_term(codes, scale, w_i8, inv_scale, n_out: int, row_map=ROWS_IDENTITY,
               offset: int = 0) -> torch.Tensor:
    """One term of the contract, T(q, s, W) = f32(f32(q @ W) * f32(s * inv)),
    over the rows that `row_map` and `offset` read of codes s8 [n_in, K] and
    scale f32 [n_in] (codes 0 and scale 0 outside them) -> f32 [n_out, N]."""
    idx, valid = tdnnf_rows(n_out, row_map, offset, codes.shape[0], codes.device)
    q = torch.where(valid[:, None], codes[idx], torch.zeros((), dtype=torch.int8,
                                                            device=codes.device))
    s = torch.where(valid, scale[idx], 0.0)
    return int8_matmul(q, w_i8).to(torch.float32) * (s * inv_scale)[:, None]


def _terms(terms, n_out: int, row_map) -> torch.Tensor:
    """The sum of the terms (codes, scale, w [K, N], inv_scale, offset), in
    order, each rounded to f32."""
    v = None
    for codes, scale, w, inv, offset in terms:
        t = tdnnf_term(codes, scale, w, inv, n_out, row_map, offset)
        v = t if v is None else v + t
    return v


def matmul_f64_in_order(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """f32 [B, K] @ f32 [K, N] -> f32: sum over k = 0, 1, ... of f64(a_k) *
    f64(b_k), each product exact in f64 and each sum rounded in f64, then
    rounded once to f32.  One fixed order, so the kernel that takes the
    same order (tdnnf_input) agrees with it bit for bit, which no f32 or
    library product's order promises."""
    a, b = a.to(torch.float64), b.to(torch.float64)
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float64, device=a.device)
    for k in range(a.shape[1]):
        acc += a[:, k, None] * b[k]
    return acc.to(torch.float32)


def tdnnf_input_step(frames_f32, w_f32, b_f32, gamma, beta):
    """tdnn1: requant(BN(ReLU(y + b1))) -> (codes s8 [B, H], scale f32 [B]),
    y = matmul_f64_in_order(x, W1).  The plain version of the tdnnf_input
    kernel."""
    v = matmul_f64_in_order(frames_f32, w_f32) + b_f32
    return requantize(torch.clamp(v, min=0.0) * gamma + beta)


def tdnnf_project_step(terms, n_out: int, row_map=ROWS_IDENTITY, bias=None):
    """A linear product on signed codes: requant(sum of the terms [+ bias])
    -> (codes s8 [n_out, N], scale f32 [n_out]); terms (codes, scale,
    w [K, N], inv_scale, offset).  The plain version of the TDNN-F layer's
    linear kernel (and prefinal-l's and prefinal-chain's second linear)."""
    v = _terms(terms, n_out, row_map)
    return requantize(v if bias is None else v + bias)


def tdnnf_expand_step(terms, n_out: int, row_map, bias, gamma, beta, bypass=None):
    """An affine product with ReLU and batchnorm: u = sum of the terms +
    bias, x = f32(f32(max(u, 0) * gamma) + beta), plus, with `bypass` =
    (codes s8, scale f32, factor 0-d f32, row map), f32(f32(q * s) * factor)
    of the rows it maps; -> requant(x).  The plain version of the TDNN-F
    layer's affine kernel (and prefinal-chain's affine, with no bypass)."""
    u = _terms(terms, n_out, row_map) + bias
    x = torch.clamp(u, min=0.0) * gamma + beta
    if bypass is not None:
        codes, scale, factor, by_map = bypass
        idx, _ = tdnnf_rows(n_out, by_map, 0, codes.shape[0], codes.device)
        x = (codes[idx].to(torch.float32) * scale[idx][:, None]) * factor + x
    return requantize(x)


def chain_logits_step(codes, scale, w_i8, inv_scale, bias):
    """The chain output: f32(T(p, O) + o) -> f32 [B, N], no softmax.  The
    plain version of the chain logits kernel."""
    return tdnnf_term(codes, scale, w_i8, inv_scale, codes.shape[0]) + bias

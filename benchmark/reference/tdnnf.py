"""The plain reference of Kaldi's TDNN-F chain net (Povey et al., Interspeech
2018; egs/librispeech/s5/local/chain/tuning/run_tdnn_1d.sh).

Written from the architecture's equations and the quantized contract the
scored system states, in plain PyTorch; it imports nothing of the program.
Each chunk [L + T + R, in] is computed whole, as its own sequence: a time
offset past either end of the chunk reads zeros, and the rows the outputs
need never do.  It holds two forwards of the same float weights:

  * `float_outputs`: the architecture itself in f32 (BN(v) = (v - mean) /
    sqrt(var + 1e-3), ReLU, bypass 0.66, frame subsampling 3, the chain
    output with no softmax), TF32 off for every product;
  * the quantized mirror (`posteriors`: the chain output, named as the
    benchmark's callers ask for an answer), which follows the contract:
    every matrix int8 by reference/net.py's rule at the cutoff, each
    batchnorm folded (gamma = f32(1 / sqrt(f64 var + 1e-3)), beta =
    f32(-f64 mean * f64 gamma)), prefinal-chain's second one into its linear
    (f32(L2 * gamma_b) by columns, then quantized, and the bias beta_b), and
    every activation after tdnn1 as int8 codes with a scale per row:

        requant(v)  s = max|v| / 127, q = clip(round_half_away(v / s), +-127)
                    (0 where s is 0)
        T(q, s, W)  f32(f32(q @ W) * f32(s * (1 / mult_W)))   q @ W exact, f64
        tdnn1       h = requant(f32(f32(max(f32(y + b1), 0) * gamma) + beta)),
                    y = f32(sum over k in order of f64(x_k) * f64(W1_k)), each
                    sum rounded in f64
        tdnnf       c = requant(f32(T(h[t - s], P_a) + T(h[t], P_b)))
                    u = f32(f32(T(c[t], E_a) + T(c[t + s], E_b)) + e)
                    h' = requant(f32(f32(f32(q_h * s_h) * 0.66)
                                     + f32(f32(max(u, 0) * gamma) + beta)))
        prefinal    g = requant(T(h, L)); v = requant(BN_a(max(f32(T(g, F) + f), 0)))
                    p = requant(f32(T(v, L2') + beta_b))
        output      y = f32(T(p, O) + o)

    the strides in rows of each layer's rate: past the first layer from
    which every stride is a multiple of 3 (tdnnf5, stride 0) only the rows
    t = 0 (mod 3) are kept.

Departures from Kaldi's float net: the int8 contract above in place of
float (the program's, which the comparison holds it to); the input rows
arrive spliced with the LDA folded into tdnn1; `input_rounding="tf32"`
(or "bf16") rounds tdnn1's operands to TF32 (bf16, to nearest even), the
reference one precision (two) below the configured f32: the controls that
the comparison has to fail.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch

from .lowrank import quantize_factor
from .net import round_half_away, tf32_round

#: tdnn1's operands under each input rounding (None: as they are)
ROUNDINGS = {
    None: lambda x: x,
    "tf32": tf32_round,
    "bf16": lambda x: x.to(torch.bfloat16).to(torch.float32),
}
#: Kaldi's BatchNormComponent epsilon
BN_EPSILON = 1e-3
CODE_MAX = 127.0
#: chunks per block of the mirror's products, so that it fits beside the
#: answers it judges
BLOCK_CHUNKS = 16


@dataclass(frozen=True)
class TdnnfFloatLayer:
    """One factorized layer: linear [in, k] per time offset (t - stride,
    then t; one at stride 0), affine [k, out] per offset (t, then t +
    stride), the bias, the batchnorm's (mean, var)."""

    stride: int
    linear: Tuple[torch.Tensor, ...]
    affine: Tuple[torch.Tensor, ...]
    bias: torch.Tensor
    bn: Tuple[torch.Tensor, torch.Tensor]


@dataclass(frozen=True)
class TdnnfFloatNet:
    """Float weights as the benchmark draws them ([in, out] each) with every
    batchnorm's (mean, var)."""

    input_w: torch.Tensor
    input_b: torch.Tensor
    input_bn: Tuple[torch.Tensor, torch.Tensor]
    layers: Sequence[TdnnfFloatLayer]
    prefinal_l: torch.Tensor
    prefinal_w: torch.Tensor
    prefinal_b: torch.Tensor
    prefinal_bn: Tuple[torch.Tensor, torch.Tensor]
    prefinal_small: torch.Tensor
    prefinal_small_bn: Tuple[torch.Tensor, torch.Tensor]
    output_w: torch.Tensor
    output_b: torch.Tensor


def fold(bn) -> Tuple[torch.Tensor, torch.Tensor]:
    mean, var = bn
    gamma = (1.0 / torch.sqrt(var.double() + BN_EPSILON)).float()
    return gamma, (-(mean.double() * gamma.double())).float()


def shift(x: torch.Tensor, offset: int) -> torch.Tensor:
    """x [C, T, D] -> y[:, t] = x[:, t + offset], zeros past either end."""
    if offset == 0:
        return x
    y = torch.zeros_like(x)
    if offset > 0:
        y[:, : x.shape[1] - offset] = x[:, offset:]
    else:
        y[:, -offset:] = x[:, : x.shape[1] + offset]
    return y


def context(strides) -> Tuple[int, int]:
    return sum(strides), sum(strides)


def drop_index(strides, factor: int) -> int:
    for i in range(len(strides)):
        if all(s % factor == 0 for s in strides[i:]):
            return i
    return len(strides)


class _Matrix:
    def __init__(self, w: torch.Tensor, cutoff: float):
        self.q, mult = quantize_factor(w, cutoff)
        self.inv = (1.0 / mult).float()


class TdnnfReference:
    """The reference's own copy of the net on `device` (module docstring)."""

    def __init__(self, net: TdnnfFloatNet, config: dict, device,
                 input_rounding: Optional[str] = None):
        if input_rounding not in ROUNDINGS:
            raise ValueError(f"input_rounding must be one of {sorted(ROUNDINGS, key=str)}, "
                             f"got {input_rounding!r}")
        self.device = torch.device(device)
        self.net = net
        self.config = config
        self.input_rounding = input_rounding
        self.strides = tuple(layer.stride for layer in net.layers)
        self.factor = config["frame_subsampling_factor"]
        self.bypass = torch.tensor(config["bypass_scale"], dtype=torch.float32, device=self.device)
        mv = lambda t: t.to(self.device, torch.float32)
        cutoff = config["cutoff"]
        self.w1 = ROUNDINGS[input_rounding](mv(net.input_w))
        self.b1 = mv(net.input_b)
        self.bn1 = tuple(map(mv, fold(net.input_bn)))
        self.layers = []
        for layer in net.layers:
            gamma, beta = fold(layer.bn)
            self.layers.append((layer.stride, [_Matrix(mv(w), cutoff) for w in layer.linear],
                                [_Matrix(mv(w), cutoff) for w in layer.affine], mv(layer.bias),
                                mv(gamma), mv(beta)))
        self.l = _Matrix(mv(net.prefinal_l), cutoff)
        self.f = _Matrix(mv(net.prefinal_w), cutoff)
        self.f_b = mv(net.prefinal_b)
        self.bn_a = tuple(map(mv, fold(net.prefinal_bn)))
        gamma_b, beta_b = fold(net.prefinal_small_bn)
        self.l2 = _Matrix(mv(net.prefinal_small) * mv(gamma_b), cutoff)
        self.l2_b = mv(beta_b)
        self.o = _Matrix(mv(net.output_w), cutoff)
        self.o_b = mv(net.output_b)

    # -- the quantized mirror ---------------------------------------------

    @staticmethod
    def requant(v: torch.Tensor):
        """[..., D] -> (codes as float64, scale f32 [...])."""
        amax = v.abs().amax(dim=-1)
        s = amax / torch.full_like(amax, CODE_MAX)
        live = s[..., None] > 0
        q = torch.clamp(round_half_away(v / torch.where(live, s[..., None], 1.0)), -CODE_MAX,
                        CODE_MAX)
        return torch.where(live, q, 0.0).double(), s

    @staticmethod
    def shifted(act, offset: int):
        """(codes, scale) of rows t + offset, zeros past the chunk's ends."""
        q, s = act
        return shift(q, offset), shift(s[..., None], offset)[..., 0]

    @classmethod
    def term(cls, act, m: _Matrix, offset: int = 0) -> torch.Tensor:
        """T(q, s, W) of rows t + offset."""
        q, s = cls.shifted(act, offset)
        return (q @ m.q).float() * (s * m.inv)[..., None]

    def _keep(self, act, first: int):
        return act[0][:, first:: self.factor], act[1][:, first:: self.factor]

    def posteriors(self, chunks: torch.Tensor) -> torch.Tensor:
        """chunks [C, L + T + R, <= in] -> the chain output f32 [C, T / 3, N]
        (no softmax), BLOCK_CHUNKS chunks at a time."""
        out = [self._outputs(chunks[i: i + BLOCK_CHUNKS])
               for i in range(0, chunks.shape[0], BLOCK_CHUNKS)]
        return torch.cat(out)

    def _outputs(self, chunks: torch.Tensor) -> torch.Tensor:
        left, right = context(self.strides)
        frames = chunks.shape[1] - left - right
        first = left % self.factor
        x = chunks.to(self.device, torch.float32)
        if x.shape[-1] < self.w1.shape[0]:
            x = torch.nn.functional.pad(x, (0, self.w1.shape[0] - x.shape[-1]))
        x = ROUNDINGS[self.input_rounding](x)
        xd, wd = x.double(), self.w1.double()
        y = torch.zeros((*x.shape[:-1], wd.shape[1]), dtype=torch.float64, device=self.device)
        for k in range(wd.shape[0]):  # the contract's order: k = 0, 1, ...
            y += xd[..., k, None] * wd[k]
        v = y.float() + self.b1
        h = self.requant(torch.clamp(v, min=0.0) * self.bn1[0] + self.bn1[1])
        drop = drop_index(self.strides, self.factor)
        rate = 1
        for i, (stride, linear, affine, bias, gamma, beta) in enumerate(self.layers):
            if i == drop:
                h_in, h = h, self._keep(h, first)
                rate = self.factor
            else:
                h_in = h
            s = stride // rate
            if stride == 0:
                c = self.requant(self.term(h, linear[0]))
                u = self.term(c, affine[0]) + bias
            else:  # h at t - stride: at the drop layer, of its full-rate input
                back = (self._keep(self.shifted(h_in, -stride), first) if i == drop
                        else self.shifted(h, -s))
                c = self.requant(self.term(back, linear[0]) + self.term(h, linear[1]))
                u = (self.term(c, affine[0]) + self.term(c, affine[1], s)) + bias
            bypass = (h[0].float() * h[1][..., None]) * self.bypass
            h = self.requant(bypass + (torch.clamp(u, min=0.0) * gamma + beta))
        if rate == 1:
            h = self._keep(h, first)
        out_first = (left - first) // self.factor
        h = (h[0][:, out_first: out_first + frames // self.factor],
             h[1][:, out_first: out_first + frames // self.factor])
        g = self.requant(self.term(h, self.l))
        v = self.requant(torch.clamp(self.term(g, self.f) + self.f_b, min=0.0) * self.bn_a[0]
                         + self.bn_a[1])
        p = self.requant(self.term(v, self.l2) + self.l2_b)
        return self.term(p, self.o) + self.o_b

    # -- the float architecture --------------------------------------------

    def float_outputs(self, chunks: torch.Tensor) -> torch.Tensor:
        """The architecture in f32, unquantized, with TF32 off for matmul and
        cuDNN while it runs: chunks -> f32 [C, T / 3, N]."""
        saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        try:
            mv = lambda t: t.to(self.device, torch.float32)
            net = self.net

            def bn(v, stats):
                mean, var = map(mv, stats)
                return (v - mean) / torch.sqrt(var + BN_EPSILON)

            left, right = context(self.strides)
            frames = chunks.shape[1] - left - right
            first = left % self.factor
            x = mv(chunks)
            h = bn(torch.relu(x @ mv(net.input_w) + mv(net.input_b)), net.input_bn)
            drop = drop_index(self.strides, self.factor)
            rate = 1
            for i, layer in enumerate(net.layers):
                h_in = h
                if i == drop:
                    h = h[:, first:: self.factor]
                    rate = self.factor
                s = layer.stride // rate
                if layer.stride == 0:
                    u = (h @ mv(layer.linear[0])) @ mv(layer.affine[0]) + mv(layer.bias)
                else:
                    back = (shift(h_in, -layer.stride)[:, first:: self.factor] if i == drop
                            else shift(h, -s))
                    c = back @ mv(layer.linear[0]) + h @ mv(layer.linear[1])
                    u = c @ mv(layer.affine[0]) + shift(c, s) @ mv(layer.affine[1]) + mv(layer.bias)
                h = self.config["bypass_scale"] * h + bn(torch.relu(u), layer.bn)
            if rate == 1:
                h = h[:, first:: self.factor]
            out_first = (left - first) // self.factor
            h = h[:, out_first: out_first + frames // self.factor]
            g = h @ mv(net.prefinal_l)
            v = bn(torch.relu(g @ mv(net.prefinal_w) + mv(net.prefinal_b)), net.prefinal_bn)
            p = bn(v @ mv(net.prefinal_small), net.prefinal_small_bn)
            return p @ mv(net.output_w) + mv(net.output_b)
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved

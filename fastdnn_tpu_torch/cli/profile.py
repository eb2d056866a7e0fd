"""Device-time profiler of the PyTorch/CUDA port, after tools/profile.py.

    python -m fastdnn_tpu_torch.cli.profile CAMPAIGN [CAMPAIGN ...] [B]
        [--device cuda|cpu] [--reps N]          # fastdnn-torch-profile

Campaigns (each ends in one JSON line whose key names it):

    trace        flagship `score_device`: each kernel's device ms per call
                 by its ops.kernels.KERNELS name, the total, the host window
                 and the device's busy share                      {"trace"}
    trace-mesh   a 1 x 1 mesh Scorer against the plain one on one card: the
                 kernel sets must be equal (no extra copy or collective)
                                                             {"trace_mesh"}
    variants     the full pass under fused_softmax x input_precision x
                 fast_posteriors, tools/profile.py's six rows  {"variants"}
    stages       input (K9 for "highest" and "high", its bf16 variant for
                 "default") / trunk (K3, or one K2 per layer) / output (K4),
                 each alone                                       {"stages"}
    dots         torch._int_mm (s8) and bf16 torch.matmul at the hidden and
                 output shapes beside K2's and K4's own time, as TOP/s
                                                                    {"dots"}
    gathered     gathered against dense `score_masked` at B = 1, 8, 32 with
                 evolving masks                                {"gathered"}
    blocksparse  a BeamDecoder's own mask trajectory: dense / block_sparse /
                 block_sparse after mask_cluster_permutation {"blocksparse"}
    int4         int8 / int4 unpacked / int4 packed: device ms and the
                 float-oracle gate (summed |d| per node over 100 frames)
                                                                    {"int4"}
    serving      the parity default against the serving knobs, bf16
                 posteriors (fast_out), the 1-pass bf16 input layer
                 (fast_in) and both (serving): device ms, the float-oracle
                 gate, max |dp|, argmax agreement         {"serving_config"}
    stack        K3 against one K2 per layer over B, and the threshold the
                 registry would record (tuning.py)          {"hidden_stack"}
    all          every campaign above, in that order, in one process

The instrument is device time from CUPTI through torch.profiler
(`profile_device`); `_device_total_ms` sums a call's kernels.  Launch
counts come from the kernel wrappers' counters (ops.kernels), never from
the trace.  The net is the flagship 432 -> 7x2048 -> 8000 with weights
from numpy seed 0, B = 8192 unless a batch is given.

`--device cuda` (the default) runs the kernels and raises without a card;
`--device cpu` runs the plain versions, whose device time is 0.
FASTDNN_PROFILE_SMOKE=1 shrinks every campaign to a 432 -> 3x256 -> 1024
net at B = 64 on the CPU unless --device says otherwise, as tools/profile.py
does: the code paths run, and the times mean nothing.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import sys
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..config import INPUT_PRECISIONS, EngineConfig
from ..ops import kernels

SMOKE = os.environ.get("FASTDNN_PROFILE_SMOKE") == "1"
#: (input dim, hidden width, hidden layers, senones); the smoke net has one
#: hidden layer more than tools/profile.py's (432, 256, 2, 1024), the fewest
#: that leave the port's stack kernel two layers to stack
NET_SHAPE = (432, 256, 3, 1024) if SMOKE else (432, 2048, 7, 8000)
BATCH = 64 if SMOKE else 8192
STACK_LADDER = (64, 128) if SMOKE else (128, 512, 1024, 2048, 4096, 8192)
FRAMES_PER_AUDIO_SECOND = 100
# published dense peaks of one H100 SXM at 700 W (NVIDIA's data sheet)
PEAK_OPS_PER_S = {"int8": 1979e12, "bf16": 989e12, "tf32": 494.7e12}
#: the reference's float-oracle gate: summed |d| per node over 100 frames
ORACLE_GATE = 0.1


# -- the instrument ------------------------------------------------------------


def profile_device(fn: Callable, calls: int = 10):
    """`fn` called `calls` times under torch.profiler (CUPTI), after one
    warm-up call -> (host window in ms per call, [(kernel name, device ms
    per call)]); the list is empty when the profiler recorded no device
    time (always on the CPU).  Launch counts come from the wrappers'
    counters, not from here."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    fn()
    sync()
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        sync()
        window_ms = (time.perf_counter() - t0) * 1e3 / calls
    device = [(e.key, e.self_device_time_total / 1e3 / calls) for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    return window_ms, device


def _device_total_ms(thunk: Callable, reps: int = 5) -> float:
    """Summed device time of every kernel of one call, in ms (0 on the CPU)."""
    return sum(ms for _, ms in profile_device(thunk, reps)[1])


def _template_flag(symbol: str, kernel: str, index: int) -> bool:
    """The `index`-th template argument of `kernel` in a demangled symbol,
    read as a bool."""
    m = re.search(re.escape(kernel) + r"<([^>]*)>", symbol)
    if m is None:
        return False
    args = [a.strip() for a in m.group(1).split(",")]
    return index < len(args) and args[index] in ("true", "1", "(bool)1")


def kernel_of(symbol: str) -> Optional[str]:
    """The ops.kernels.KERNELS name of a CUDA kernel as the profiler names
    it (its demangled symbol), or None for a kernel that is not the port's.
    K2 and K5 share csrc/hopper.cuh's streamed_layer_kernel (their
    epilogues tell them apart), K4 and K6 the resident softmax kernel (its
    SPARSE flag), K8 and its skipping variant the stats kernel (SKIP)."""
    if "streamed_layer_kernel" in symbol:
        if "LogitsEpilogue" in symbol:
            return "output_logits"
        return "hidden_layer" if "SigmoidEpilogue" in symbol else None
    if "resident_softmax_wgmma_kernel" in symbol:
        sparse = _template_flag(symbol, "resident_softmax_wgmma_kernel", 1)
        return "resident_softmax_block_sparse" if sparse else "resident_softmax"
    if "flash_stats_kernel" in symbol:
        skip = _template_flag(symbol, "flash_stats_kernel", 2)
        return "flash_stats_block_sparse" if skip else "flash_stats"
    for name, kernel in (("input_layer", "input_layer_kernel"),
                         ("input_layer_bf16", "input_layer_bf16_kernel"),
                         ("bias_sigmoid_i8", "bias_sigmoid_kernel"),
                         ("hidden_stack", "hidden_stack_wgmma_kernel"),
                         ("hidden_layer_packed", "hidden_layer_packed_kernel"),
                         ("normalize_stats", "normalize_stats_kernel"),
                         ("lazy_output", "lazy_output_kernel"),
                         ("lowrank_layer", "lowrank_layer_kernel"),
                         ("lowrank_bottleneck", "lowrank_bottleneck_kernel"),
                         ("tdnnf_input", "tdnnf_input_kernel"),
                         ("tdnnf_project", "tdnnf_project_kernel"),
                         ("tdnnf_expand", "tdnnf_expand_kernel"),
                         ("chain_project", "chain_project_kernel"),
                         ("chain_expand", "chain_expand_kernel"),
                         ("chain_logits", "chain_logits_kernel")):
        if kernel in symbol:
            return name
    return None


def by_kernel(device_rows) -> tuple[dict, dict]:
    """Profiler rows -> ({KERNELS name: ms}, {other kernel's symbol: ms})."""
    ours: dict = {}
    other: dict = {}
    for symbol, ms in device_rows:
        name = kernel_of(symbol)
        if name is None:
            other[symbol] = other.get(symbol, 0.0) + ms
        else:
            ours[name] = ours.get(name, 0.0) + ms
    return ours, other


# -- the nets and inputs -------------------------------------------------------


class Context:
    """What every campaign shares: the device, batch, reps and the flagship
    net (drawn once per process)."""

    def __init__(self, device: torch.device, batch: int, reps: int):
        self.device = device
        self.batch = batch
        self.reps = reps
        self._net = None
        self._qnets: dict = {}
        if device.type == "cuda":
            # a throwaway session, so that no measured window holds the
            # process's first one (on an H100 a first 3-call trace read 43%
            # busy where the next read 80%)
            profile_device(lambda: torch.cuda.synchronize(device), 1)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def float_net(self):
        if self._net is None:
            from ..models.feedforward import random_net

            d_in, hidden, layers, out = NET_SHAPE
            self._net = random_net(np.random.default_rng(0), d_in, [hidden] * layers, out)
        return self._net

    def qnet(self, hidden_bits: int = 8):
        """The flagship quantized (once per width)."""
        if hidden_bits not in self._qnets:
            from ..quant.quantize import quantize_net

            self._qnets[hidden_bits] = quantize_net(self.float_net(), cutoff=3.0,
                                                    hidden_bits=hidden_bits)
        return self._qnets[hidden_bits]

    def scorer(self, qnet=None, **config):
        from ..engine.scorer import Scorer

        return Scorer(qnet if qnet is not None else self.qnet(), EngineConfig(**config),
                      device=self.device)

    def frames(self, b: int, seed: int = 0) -> torch.Tensor:
        x = np.random.default_rng(seed).standard_normal((b, NET_SHAPE[0]), dtype=np.float32)
        return torch.from_numpy(x).to(self.device)

    def ms(self, thunk: Callable) -> float:
        return _device_total_ms(thunk, self.reps)


def _emit(key: str, record) -> dict:
    print(json.dumps({key: record}), flush=True)
    return record


def _per_s(amount: float, ms: float) -> float:
    """`amount` per second over `ms`; 0 where no device time was recorded."""
    return amount / ms * 1e3 if ms > 0 else 0.0


def _audio_s(b: int, ms: float) -> float:
    return _per_s(b / FRAMES_PER_AUDIO_SECOND, ms)


# -- campaigns -----------------------------------------------------------------


def _trace(ctx: Context, sc, frames: torch.Tensor, label: str) -> dict:
    """Trace sc.score_device(frames): per-kernel device ms per call, the
    host window, the busy share and the launches of one call."""
    b = frames.shape[0]
    kernels.reset_launch_counts()
    sc.score_device(frames)
    ctx.sync()
    launched = {k: v for k, v in kernels.launch_counts().items() if v}
    window_ms, rows = profile_device(lambda: sc.score_device(frames), ctx.reps)
    ours, other = by_kernel(rows)
    total = sum(ours.values()) + sum(other.values())
    busy = total / window_ms if window_ms > 0 else 0.0
    print(f"{label}, batch {b} (ms per call, device time; {ctx.reps} calls):", flush=True)
    for name, ms in sorted({**ours, **other}.items(), key=lambda kv: -kv[1]):
        print(f"  {ms:8.4f} ms  {name[:100]}")
    print(f"total {total:.4f} ms of a {window_ms:.4f} ms host window: device busy {busy:.1%}; "
          f"{_audio_s(b, total):,.0f} audio-s/s device-side; launches of one call: {launched}",
          flush=True)
    return {"batch": b, "kernels": ours, "other": other, "launched": launched,
            "total_ms": total, "window_ms": window_ms, "busy": busy}


def cmd_trace(ctx: Context) -> dict:
    return _emit("trace", _trace(ctx, ctx.scorer(), ctx.frames(ctx.batch), "flagship score_device"))


def cmd_trace_mesh(ctx: Context) -> dict:
    """A 1 x 1 mesh Scorer on the one device against the plain Scorer: the
    mesh wrapper must add no kernel (no copy, no collective)."""
    import torch.distributed as dist

    from ..parallel.mesh import init_multihost, make_mesh
    from ..parallel.spawn import free_port

    frames = ctx.frames(ctx.batch)
    qnet = ctx.qnet()
    plain = _trace(ctx, ctx.scorer(qnet), frames, "single device")
    init_multihost(f"tcp://localhost:{free_port()}", world_size=1, rank=0, backend="gloo")
    try:
        mesh = make_mesh(1, 1, device_type=ctx.device.type)
        from ..engine.scorer import Scorer

        mesh_rec = _trace(ctx, Scorer(qnet, EngineConfig(), device=ctx.device, mesh=mesh),
                          frames, "mesh(1, 1)")
    finally:
        dist.destroy_process_group()

    def names(rec):
        return set(rec["kernels"]) | set(rec["other"])

    extra = sorted(names(mesh_rec) - names(plain))
    missing = sorted(names(plain) - names(mesh_rec))
    print(f"\nkernels only in the mesh program: {extra or 'NONE'}; only in the plain one: "
          f"{missing or 'NONE'}", flush=True)
    return _emit("trace_mesh", {"batch": ctx.batch, "plain": sorted(names(plain)),
                                "mesh": sorted(names(mesh_rec)), "extra": extra,
                                "missing": missing, "plain_ms": plain["total_ms"],
                                "mesh_ms": mesh_rec["total_ms"]})


#: tools/profile.py's variant rows: (fused_softmax, input_precision,
#: fast_posteriors)
VARIANTS = (
    (False, "highest", False),
    (False, "high", False),
    (True, "high", False),
    (True, "high", True),
    (True, "default", False),
    (True, "default", True),
)


def cmd_variants(ctx: Context) -> dict:
    """The full pass under the switches of tools/profile.py's variants:
    the logits kernel and a library softmax, or the fused softmax; K9
    ("highest", "high") or its bf16 variant ("default") for the input
    layer; f32 or bf16 posteriors.  Rows are named
    fused{0|1}_{precision}_fast{0|1}."""
    frames = ctx.frames(ctx.batch)
    qnet = ctx.qnet()
    out = {}
    for fused, prec, fast in VARIANTS:
        name = f"fused{int(fused)}_{prec}_fast{int(fast)}"
        sc = ctx.scorer(qnet, fused_softmax=fused, input_precision=prec, fast_posteriors=fast)
        ms = ctx.ms(lambda sc=sc: sc.score_device(frames))
        out[name] = {"ms": ms, "audio_s_per_s": _audio_s(ctx.batch, ms)}
        print(f"fused={int(fused)} prec={prec:8s} fast={int(fast)}  {ms:8.4f} ms/batch  "
              f"audio-s/s {out[name]['audio_s_per_s']:9.0f}", flush=True)
    return _emit("variants", {"batch": ctx.batch, **out})


def _per_layer(sc, acts):
    net, step = sc.net, sc._route.backend.hidden_layer
    for i in range(len(net.weights) - 1):
        acts = step(acts, net.weights[i], net.colsum128[i], net.inv_scales[i], net.biases[i])
    return acts


def _output(sc, acts):
    return sc._route.backend.posteriors(sc.net, acts, None, out_dim=sc.output_dim)


def cmd_stages(ctx: Context) -> dict:
    """Each stage of the pass alone: the input layer under each input
    precision (K9 for "highest" and "high", counted as TF32 operations; its
    bf16 variant for "default", as bf16 operations; each from a Scorer made
    for that precision), the trunk (K3, and one K2 per layer) and the output
    layer with its softmax (K4)."""
    scorers = {p: ctx.scorer(input_precision=p) for p in INPUT_PRECISIONS}
    sc = scorers["high"]
    frames = ctx.frames(ctx.batch)
    b, (d_in, hidden, layers, out_dim) = ctx.batch, NET_SHAPE
    acts0 = sc._route.backend.input_layer(sc.net, frames, "high")
    acts = _per_layer(sc, acts0)
    rows = {
        f"input_{p}": (lambda s=s, p=p: s._route.backend.input_layer(s.net, frames, p),
                       2 * b * d_in * hidden, "bf16" if p == "default" else "tf32")
        for p, s in scorers.items()
    }
    rows |= {
        "trunk_per_layer": (lambda: _per_layer(sc, acts0),
                            2 * b * hidden * hidden * (layers - 1), "int8"),
        "output": (lambda: _output(sc, acts), 2 * b * hidden * out_dim, "int8"),
    }
    if sc._hstack is not None:
        rows["trunk_stack"] = (lambda: sc._route.backend.hidden_stack(acts0, sc._hstack),
                               rows["trunk_per_layer"][1], "int8")
    out = {}
    for name, (fn, ops, kind) in rows.items():
        ms = ctx.ms(fn)
        rate = _per_s(ops, ms)
        out[name] = {"ms": ms, "tops": rate / 1e12, "peak_share": rate / PEAK_OPS_PER_S[kind]}
        print(f"{name:16s} {ms:8.4f} ms  {rate / 1e12:7.1f} T{kind} ops/s "
              f"({out[name]['peak_share']:.1%} of {PEAK_OPS_PER_S[kind] / 1e12:g})", flush=True)
    return _emit("stages", {"batch": b, **out})


def cmd_dots(ctx: Context) -> dict:
    """The products alone at the flagship's hidden and output shapes:
    torch._int_mm (s8 x s8 -> s32) and bf16 torch.matmul, beside K2's and
    K4's own time on the same shapes, as TOP/s against the card's dense
    peaks (int8 1,979, bf16 989)."""
    b, (_, hidden, _, out_dim) = ctx.batch, NET_SHAPE
    g = torch.Generator().manual_seed(0)
    a = torch.randint(-128, 128, (b, hidden), dtype=torch.int8, generator=g).to(ctx.device)
    w_h = torch.randint(-127, 128, (hidden, hidden), dtype=torch.int8, generator=g).to(ctx.device)
    w_o = torch.randint(-127, 128, (hidden, out_dim), dtype=torch.int8, generator=g).to(ctx.device)
    a_bf, w_h_bf, w_o_bf = (x.to(torch.bfloat16) for x in (a, w_h, w_o))
    sc = ctx.scorer()
    net = sc.net
    layer = (net.weights[0], net.colsum128[0], net.inv_scales[0], net.biases[0])
    shapes = {"hidden": 2 * b * hidden * hidden, "output": 2 * b * hidden * out_dim}
    rows = {
        "int_mm_hidden": (lambda: torch._int_mm(a, w_h), "hidden", "int8"),
        "bf16_hidden": (lambda: a_bf @ w_h_bf, "hidden", "bf16"),
        "K2_hidden_layer": (lambda: sc._route.backend.hidden_layer(a, *layer), "hidden", "int8"),
        "int_mm_output": (lambda: torch._int_mm(a, w_o), "output", "int8"),
        "bf16_output": (lambda: a_bf @ w_o_bf, "output", "bf16"),
        "K4_resident_softmax": (lambda: _output(sc, a), "output", "int8"),
    }
    out = {}
    for name, (fn, shape, kind) in rows.items():
        ms = ctx.ms(fn)
        tops = _per_s(shapes[shape], ms) / 1e12
        out[name] = {"ms": ms, "tops": tops, "peak_share": tops * 1e12 / PEAK_OPS_PER_S[kind]}
        print(f"{name:20s} {ms:8.4f} ms  {tops:7.1f} T{kind} ops/s "
              f"({out[name]['peak_share']:.1%} of {PEAK_OPS_PER_S[kind] / 1e12:g})", flush=True)
    return _emit("dots", {"batch": b, **out})


def cmd_gathered(ctx: Context) -> dict:
    """Gathered against dense masked output at decoder batch sizes (B = 1,
    8, 32), with evolving masks at densities 0.4 and 0.05.  Device time
    only (the host's union of the masks is left out)."""
    from ..engine.lazy import union_active_indices
    from .score import generate_masks

    sc = ctx.scorer()
    frames_all = np.random.default_rng(0).standard_normal((32, NET_SHAPE[0]), dtype=np.float32)
    masks_by_d = {d: generate_masks(np.random.default_rng(1), 32, sc.output_dim, d, churn_frac=0.02)
                  for d in (0.4, 0.05)}
    print("flagship masked output (device ms/call):")
    print(f"{'dens':>5} {'B':>4} {'union':>6} {'dense':>9} {'gathered':>9} {'ratio':>7}")
    rows = []
    for d in (0.4, 0.05):
        for b in (1, 8, 32):
            padded, _ = sc._prepare(frames_all[:b])
            masks_p = sc._pad_masks(masks_by_d[d][:b], padded.shape[0])
            mp = sc._to_device(masks_p)
            union = int(masks_p.any(axis=0).sum())
            cap = min(-(-union // 128) * 128, sc.output_dim)
            idx, count = union_active_indices(masks_p, cap)
            idx_dev = sc._to_device(idx)
            dense_ms = ctx.ms(lambda: sc._run_masked(padded, mp))
            gath_ms = ctx.ms(lambda: sc._gathered(sc._hidden(padded), mp, idx_dev))
            ratio = dense_ms / max(gath_ms, 1e-9)
            rows.append({"density": d, "B": b, "union": count, "dense_ms": dense_ms,
                         "gathered_ms": gath_ms, "ratio": ratio})
            print(f"{d:>5.2f} {b:>4} {count:>6} {dense_ms:>9.4f} {gath_ms:>9.4f} {ratio:>6.2f}x",
                  flush=True)
    return _emit("gathered", rows)


def cmd_blocksparse(ctx: Context) -> dict:
    """Block-sparse against dense masked output on a live beam's masks: the
    BeamDecoder records a trajectory over the flagship net, which is then
    scored tiled to B in {32, 256, 8192} three ways on one quantized net:
    dense (K4 masked), block_sparse (K6 on the raw senone ids) and
    block_sparse after mask_cluster_permutation (derived from the first
    half of the trajectory, measured on the second).  skip is the share of
    K6's (64-frame x 128-senone) tiles that are all inactive."""
    from ..decoder import BeamDecoder, Lexicon, random_lexicon
    from ..engine.cluster import mask_cluster_permutation, permute_output_layer

    qnet = ctx.qnet()
    senones = NET_SHAPE[3]
    sc = ctx.scorer(qnet)
    rng = np.random.default_rng(7)
    t_frames = 64 if SMOKE else 512
    batches = (16, 32) if SMOKE else (32, 256, 8192)
    frames = rng.standard_normal((t_frames, NET_SHAPE[0]), dtype=np.float32)
    track = sc.score(frames).argmax(1)
    dedup = track[np.insert(np.diff(track) != 0, 0, True)]
    true_words = [tuple(int(s) for s in dedup[i : i + 4])
                  for i in range(0, len(dedup) - 3, 4)][:40]
    lex = Lexicon(tuple(true_words) + random_lexicon(
        rng, 40 if SMOKE else 560, senones, min_states=4, max_states=8).words)
    dec = BeamDecoder(lex, senones, beam_width=64 if SMOKE else 256, word_exit_beam=32)
    res = dec.decode_dense(sc, frames)
    half = t_frames // 2
    perm = mask_cluster_permutation(res.masks[:half])
    masks_t, frames_t = res.masks[half:], frames[half:]
    print(f"live beam trajectory: density {res.avg_density:.3f}, churn {res.avg_churn:.4f}, "
          f"eval frames {masks_t.shape[0]}", flush=True)
    sc_cl = ctx.scorer(permute_output_layer(qnet, perm))

    def block_sparse(s, padded, m):
        route = dataclasses.replace(s._route, semantics="reference", block_sparse=True)
        return route.score_masked(s.net, padded, m)

    def skip(m):
        pad = -m.shape[1] % kernels.TILE_N
        return kernels.block_skip_share(torch.nn.functional.pad(m, (0, pad)).cpu())

    print(f"{'B':>5} {'skip':>6} {'skip cl':>7} {'dense':>9} {'bs':>9} {'bs+cl':>9} "
          f"{'best vs dense':>13}")
    rows = []
    for b in batches:
        reps = -(-b // masks_t.shape[0])
        masks = np.tile(masks_t, (reps, 1))[:b]
        padded, _ = sc._prepare(np.tile(frames_t, (reps, 1))[:b])
        mp = sc._to_device(sc._pad_masks(masks, padded.shape[0]))
        mp_cl = sc._to_device(sc._pad_masks(masks[:, perm], padded.shape[0]))
        d_ms = ctx.ms(lambda: sc._run_masked(padded, mp))
        b_ms = ctx.ms(lambda: block_sparse(sc, padded, mp))
        c_ms = ctx.ms(lambda: block_sparse(sc_cl, padded, mp_cl))
        best = max(min(b_ms, c_ms), 1e-9)
        rows.append({"B": b, "skip": skip(mp), "skip_cl": skip(mp_cl), "dense_ms": d_ms,
                     "bs_ms": b_ms, "bs_cluster_ms": c_ms, "speedup": d_ms / best})
        r = rows[-1]
        print(f"{b:>5} {r['skip']:>6.1%} {r['skip_cl']:>7.1%} {d_ms:>9.4f} {b_ms:>9.4f} "
              f"{c_ms:>9.4f} {d_ms / best:>12.2f}x", flush=True)
    return _emit("blocksparse", {"rows": rows, "density": res.avg_density, "churn": res.avg_churn})


def _oracle(ctx: Context, f100: np.ndarray) -> np.ndarray:
    from ..models.feedforward import forward

    return forward(ctx.float_net(), torch.from_numpy(f100)).numpy()


def cmd_int4(ctx: Context) -> dict:
    """int8 against the int4 trunk, unpacked (int4 values through the int8
    kernels) and packed (K7): device ms and the reference's float-oracle
    gate, each variant on its own so one failure keeps the others."""
    variants = {
        "int8": lambda: ctx.scorer(ctx.qnet()),
        "int4": lambda: ctx.scorer(ctx.qnet(hidden_bits=4)),
        "int4_packed": lambda: ctx.scorer(ctx.qnet(hidden_bits=4), int4_packed=True),
    }
    f100 = np.random.default_rng(3).standard_normal((100, NET_SHAPE[0]), dtype=np.float32)
    fl = _oracle(ctx, f100)
    frames = ctx.frames(ctx.batch)
    out = {"batch": ctx.batch}
    for name, make in variants.items():
        try:
            sc = make()
            gate = float(np.abs(sc.score(f100) - fl).sum(axis=0).max())
            ms = ctx.ms(lambda sc=sc: sc.score_device(frames))
            out[name] = {"ms": ms, "oracle_gate": gate}
            print(f"{name:12s} {ms:8.4f} ms/{ctx.batch}  float-oracle max summed |d| = {gate:.4f} "
                  f"(gate: < {ORACLE_GATE})", flush=True)
        except Exception as e:  # each variant on its own
            out[name] = {"error": f"{type(e).__name__}: {e}"[:300]}
            print(f"{name:12s} FAILED: {type(e).__name__}: {e}", flush=True)
    return _emit("int4", out)


#: tools/profile.py's serving configs: name -> EngineConfig fields
SERVING_CONFIGS = {
    "parity": {},
    "fast_out": {"fast_posteriors": True},
    "fast_in": {"input_precision": "default"},
    "serving": {"input_precision": "default", "fast_posteriors": True},
}


def cmd_serving(ctx: Context) -> dict:
    """The serving knobs against the parity default, as tools/profile.py's
    serving campaign: bf16 posteriors (fast_out), the 1-pass bf16 input
    layer (fast_in) and both (serving, the JAX package's documented serving
    configuration): device ms, the float-oracle gate, max |dp| and argmax
    agreement against the parity config on 100 frames."""
    qnet = ctx.qnet()
    scorers = {name: ctx.scorer(qnet, **fields) for name, fields in SERVING_CONFIGS.items()}
    f100 = np.random.default_rng(3).standard_normal((100, NET_SHAPE[0]), dtype=np.float32)
    fl = _oracle(ctx, f100)
    p_parity = scorers["parity"].score(f100)
    frames = ctx.frames(ctx.batch)
    out = {}
    for name, sc in scorers.items():
        p = sc.score(f100)
        ms = ctx.ms(lambda sc=sc: sc.score_device(frames))
        out[name] = {
            "ms": ms,
            "oracle_gate": float(np.abs(p - fl).sum(axis=0).max()),
            "max_dp_vs_parity": float(np.abs(p - p_parity).max()),
            "argmax_agree": float((p.argmax(1) == p_parity.argmax(1)).mean()),
        }
        r = out[name]
        print(f"{name:8s} {ms:8.4f} ms/{ctx.batch}  oracle {r['oracle_gate']:.4f}  "
              f"max|dp| {r['max_dp_vs_parity']:.2e}  argmax {r['argmax_agree']:.4f}", flush=True)
    return _emit("serving_config", {"batch": ctx.batch, **out})


def stack_threshold(rows: dict) -> int:
    """The stack threshold by the JAX package's rule: the largest B at which
    the stack kernel still beats one layer kernel per layer (the stack then
    serves every batch up to it), 0 when it never does."""
    wins = [b for b, r in rows.items() if r["stack_ms"] < r["per_layer_ms"]]
    return max(wins, default=0)


def stack_rows(ctx: Context, stack_fn, per_layer_fn, ladder) -> dict:
    """{B: {"stack_ms", "per_layer_ms"}} over `ladder`, the two timed in
    turns at each B: stack, per-layer, per-layer, stack (the mean of each
    pair).  `*_fn(b)` gives the zero-argument call to time at B."""
    rows = {}
    for b in ladder:
        s, p = stack_fn(b), per_layer_fn(b)
        times = [ctx.ms(s), ctx.ms(p), ctx.ms(p), ctx.ms(s)]
        rows[b] = {"stack_ms": (times[0] + times[3]) / 2, "per_layer_ms": (times[1] + times[2]) / 2}
        r = rows[b]
        print(f"B={b:5d}  per-layer {r['per_layer_ms']:8.4f} ms  stack {r['stack_ms']:8.4f} ms  "
              f"({r['per_layer_ms'] / max(r['stack_ms'], 1e-9):.2f}x)", flush=True)
    return rows


def cmd_stack(ctx: Context) -> dict:
    """The whole trunk in one K3 launch against one K2 launch per layer,
    over B (the full pass, so the rows are what a Scorer would see), and
    the threshold `stack_hidden_max_frames` would take from them."""
    sc = ctx.scorer()
    if sc._hstack is None:
        raise ValueError("the net's trunk does not fit the stack kernel")
    frames = ctx.frames(max(STACK_LADDER), seed=1)

    def run(stack: bool):
        route = dataclasses.replace(sc._route, stack_max_frames=(1 << 30) if stack else 0)

        def at(b):
            x = frames[:b]
            return lambda: route.score(sc.net, x)
        return at

    rows = stack_rows(ctx, run(True), run(False), STACK_LADDER)
    threshold = stack_threshold(rows)
    print(f"stack_hidden_max_frames by these rows: {threshold}", flush=True)
    return _emit("hidden_stack", {"rows": {str(b): r for b, r in rows.items()},
                                  "threshold": threshold})


CAMPAIGNS = {
    "trace": cmd_trace,
    "trace-mesh": cmd_trace_mesh,
    "variants": cmd_variants,
    "stages": cmd_stages,
    "dots": cmd_dots,
    "gathered": cmd_gathered,
    "blocksparse": cmd_blocksparse,
    "int4": cmd_int4,
    "serving": cmd_serving,
    "stack": cmd_stack,
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="fastdnn-torch-profile",
        description="Device-time measurement campaigns of the PyTorch/CUDA port",
    )
    p.add_argument("campaigns", nargs="+", metavar="CAMPAIGN [B]",
                   help=f"one or more of {', '.join(CAMPAIGNS)} or all, then an optional "
                   f"batch (default {BATCH})")
    p.add_argument("--device", choices=["cuda", "cpu"], default=None,
                   help="cuda (default; the cpu under FASTDNN_PROFILE_SMOKE=1): the kernels, "
                   "failing without a GPU; cpu: the plain versions (device time 0)")
    p.add_argument("--reps", type=int, default=5, help="profiled calls per measurement")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    names, batch = [], BATCH
    for token in args.campaigns:
        if token.isdigit():
            batch = int(token)
        elif token == "all":
            names += list(CAMPAIGNS)
        elif token in CAMPAIGNS:
            names.append(token)
        else:
            raise ValueError(f"unknown campaign {token!r}; choose from {', '.join(CAMPAIGNS)}, all")
    if not names:
        raise ValueError("name a campaign")
    device = torch.device(args.device or ("cpu" if SMOKE else "cuda"))
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: CUDA is not available; pass --device cpu")
    if args.reps < 1:
        raise ValueError(f"--reps must be >= 1, got {args.reps}")
    ctx = Context(device, batch, args.reps)
    for name in names:
        print(f"\n== campaign {name} (batch {batch}, {device})", flush=True)
        t0 = time.perf_counter()
        CAMPAIGNS[name](ctx)
        print(f"== campaign {name}: {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


def _cli(argv=None) -> int:
    """Entry point with one-line error reporting for expected failures
    (an unknown campaign, no GPU)."""
    try:
        return main(argv)
    except (OSError, ValueError, RuntimeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(_cli())

"""The port's Scorer over the grid of EngineConfig knobs against the JAX
package, on CPU.

Every knob was held to the JAX package alone; this file holds them
together.  The full cross of fused_softmax x fast_posteriors x net runs,
with a pairwise covering set of the other knobs (lazy_semantics,
lazy_mode dense / gathered at capacity 1.0, the int8, int4 and packed int4
trunk, input_precision "high" / "default", and n = 1 or n = 77 frames with
one fully masked frame).  The nets: 432 -> 3x256 -> 1000 (the resident
softmax route) and 432 -> 2x2304 -> 3000 (K = 2304 > 2048: the stats route,
whose 3000 senones are not a multiple of 128).  Each combination checks
`score`, `score_masked` and, on the narrow net, a 4-frame LazyContext.

The JAX package scores with XLA on the CPU, where fused_softmax and
fast_posteriors do not apply, so every JAX posterior is f32; each net is
quantized and scored once per trunk, precision and semantics.  The JAX
package on the CPU ignores `precision`, so "default" is held, as
tests/test_torch_precision.py holds it, against JAX on operands rounded to
bf16.  Bounds, the repo's own:
  * f32 posteriors from frames: within 1e-4, argmax agreement >= 99.9%;
  * bf16 posteriors (fused_softmax with fast_posteriors): within rtol 2e-2,
    atol 1e-3 of JAX's f32 ones, and every value a bf16 value.
"""

import dataclasses
import functools
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fastdnn_tpu as fd
import fastdnn_tpu_torch as fdt
from fastdnn_tpu_torch.cli import serve
from fastdnn_tpu_torch.engine.scorer import score_fn
from fastdnn_tpu_torch.ops import matmul as tops
from fastdnn_tpu_torch.quant.quantize import pad_qnet

POSTERIOR_ATOL = 1e-4
ARGMAX_AGREEMENT = 0.999
BF16_RTOL, BF16_ATOL = 2e-2, 1e-3
STATS_RTOL = 1e-5
N_FRAMES, MASKED_FRAME, LAZY_FRAMES = 77, 3, 4
# name -> (hidden widths, senones, seed)
NETS = {"narrow": ([256, 256, 256], 1000, 1000), "wide": ([2304, 2304], 3000, 2304)}
TRUNKS = ("int8", "int4", "int4_packed")

# (trunk, lazy_semantics, lazy_mode, input_precision, frames): each pair
# of values of two of these knobs is in some row (test_rows_cover_every_pair)
COVERING = [
    ("int8", "reference", "dense", "high", 77),
    ("int8", "active_only", "gathered", "default", 1),
    ("int4", "reference", "gathered", "default", 77),
    ("int4", "active_only", "dense", "high", 1),
    ("int4_packed", "reference", "dense", "default", 1),
    ("int4_packed", "active_only", "gathered", "high", 77),
]
LEVELS = [TRUNKS, ("reference", "active_only"), ("dense", "gathered"), ("high", "default"),
          (1, N_FRAMES)]


def _bf16(x) -> np.ndarray:
    """f32 -> the nearest bf16 (ties to even), back as f32, in JAX."""
    return np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))


def _carry(j_q, tmp_path):
    """A JAX QuantizedNet -> the port, through the checkpoint arrays."""
    fd.save_qnet(j_q, tmp_path / "q.npz")
    with np.load(tmp_path / "q.npz") as z:
        return fdt.qnet_from_arrays({k: np.asarray(z[k]) for k in z.files})


class Net:
    """One float net quantized both ways (int8 and int4 trunks) in the JAX
    package and carried to the port, with its frames, masks and the JAX
    posteriors, each computed once."""

    def __init__(self, name, tmp_path):
        hidden, out, seed = NETS[name]
        self.name, self.out = name, out
        t_net = fdt.random_net(np.random.default_rng(seed), 432, hidden, out)
        j_net = fd.from_raw(fdt.to_raw(t_net))
        self.j_q = {bits: fd.quantize_net(j_net, hidden_bits=bits) for bits in (8, 4)}
        self.t_q = {}
        for bits, q in self.j_q.items():
            (tmp_path / f"int{bits}").mkdir()
            self.t_q[bits] = _carry(q, tmp_path / f"int{bits}")
        rng = np.random.default_rng(seed + 1)
        self.frames = rng.standard_normal((N_FRAMES, 432), dtype=np.float32)
        self.masks = (rng.random((N_FRAMES, out)) < 0.4).astype(np.uint8)
        self.masks[MASKED_FRAME] = 0  # a frame with no active senone
        self._want = functools.lru_cache(maxsize=None)(self._jax)

    def _jax(self, bits, precision, semantics):
        """JAX's (score, score_masked) on all N_FRAMES frames; under
        "default", on the frames and input weight rounded to bf16."""
        j_q, frames = self.j_q[bits], self.frames
        if precision == "default":
            j_q = dataclasses.replace(j_q, input_w=jnp.asarray(_bf16(j_q.input_w)))
            frames = _bf16(frames)
        sc = fd.Scorer(j_q, fd.EngineConfig(backend="xla", lazy_semantics=semantics))
        return sc.score(frames), sc.score_masked(frames, self.masks)

    def want(self, bits, precision, semantics, n):
        return tuple(p[:n] for p in self._want(bits, precision, semantics))


@pytest.fixture(scope="module")
def nets(tmp_path_factory):
    return {name: Net(name, tmp_path_factory.mktemp(name)) for name in NETS}


def _assert_close(got, want, bf16):
    assert got.shape == want.shape and got.dtype == np.float32 and np.isfinite(got).all()
    if bf16:
        np.testing.assert_array_equal(got, _bf16(got))
        np.testing.assert_allclose(got, want, rtol=BF16_RTOL, atol=BF16_ATOL)
        return
    assert np.abs(got - want).max() <= POSTERIOR_ATOL
    assert (got.argmax(1) == want.argmax(1)).mean() >= ARGMAX_AGREEMENT


def test_rows_cover_every_pair():
    """COVERING holds every pair of values of every two knobs it sets."""
    for (i, a), (j, b) in itertools.combinations(enumerate(LEVELS), 2):
        seen = {(row[i], row[j]) for row in COVERING}
        assert seen == set(itertools.product(a, b)), (i, j)


@pytest.mark.parametrize("row", COVERING, ids=["-".join(map(str, r)) for r in COVERING])
@pytest.mark.parametrize("net_name", list(NETS))
@pytest.mark.parametrize("fast", [False, True], ids=["f32", "fast"])
@pytest.mark.parametrize("fused", [False, True], ids=["logits", "fused"])
def test_scorer_matches_jax(nets, fused, fast, net_name, row):
    """score, score_masked and (narrow net) a 4-frame LazyContext of
    Scorer(device="cpu") under one combination, against the JAX Scorer.
    bf16 comes out exactly where the port promises it: fused_softmax with
    fast_posteriors on the dense paths; gathered and LazyContext stay f32."""
    trunk, semantics, mode, precision, n = row
    net = nets[net_name]
    bits = 8 if trunk == "int8" else 4
    cfg = fdt.EngineConfig(
        fused_softmax=fused, fast_posteriors=fast, lazy_semantics=semantics, lazy_mode=mode,
        lazy_capacity=1.0, int4_packed=trunk == "int4_packed", input_precision=precision,
    )
    scorer = fdt.Scorer(net.t_q[bits], cfg, device="cpu")
    frames, masks = net.frames[:n], net.masks[:n]
    want, want_masked = net.want(bits, precision, semantics, n)
    bf16 = fused and fast
    _assert_close(scorer.score(frames), want, bf16)
    got_masked = scorer.score_masked(frames, masks)
    _assert_close(got_masked, want_masked, bf16 and mode == "dense")
    if n > MASKED_FRAME:
        if semantics == "active_only":
            np.testing.assert_array_equal(got_masked[MASKED_FRAME], 0.0)
        else:
            np.testing.assert_allclose(got_masked[MASKED_FRAME], 1.0 / net.out,
                                       rtol=BF16_RTOL if bf16 and mode == "dense" else 1e-6)
    if net_name == "narrow":
        ctx = scorer.new_lazy_context(LAZY_FRAMES)
        ctx.calculate_until_output(net.frames[:LAZY_FRAMES])
        rows = np.stack([ctx.calculate_for_output_nodes(m) for m in net.masks[:LAZY_FRAMES]])
        _assert_close(rows, net.want(bits, precision, semantics, LAZY_FRAMES)[1], False)


@pytest.mark.parametrize("entry", ["Scorer", "score_fn", "serve"])
def test_fast_stats_on_3000_senones(nets, entry, tmp_path):
    """The regression: fused fast posteriors on the wide net, whose output
    layer takes the stats route with 3000 senones (not a multiple of 128),
    raised "fast stats need N a multiple of 128" on the plain route, through
    the Scorer, score_fn on the unpadded net and the serve CLI's
    `--device cpu --fast-posteriors` scorer.  They are bf16 posteriors
    within bf16's bounds of JAX's."""
    net = nets["wide"]
    want, _ = net.want(8, "high", "reference", N_FRAMES)
    cfg = fdt.EngineConfig(fused_softmax=True, fast_posteriors=True)
    if entry == "Scorer":
        got = fdt.Scorer(net.t_q[8], cfg, device="cpu").score(net.frames)
    elif entry == "score_fn":
        with torch.inference_mode():
            out = score_fn(net.t_q[8], torch.as_tensor(net.frames), backend="torch",
                           fused_softmax=True, fast_posteriors=True)
        assert out.dtype == torch.bfloat16 and out.shape == (N_FRAMES, net.out)
        got = out.float().numpy()
    else:
        fd.save_qnet(net.j_q[8], tmp_path / "q.npz")
        args = serve.build_parser().parse_args(
            [str(tmp_path / "q.npz"), "--device", "cpu", "--fast-posteriors"])
        scorer, _ = serve.build_scorer(args)
        assert scorer.config.fast_posteriors and scorer.config.fused_softmax
        got = scorer.score(net.frames)
    _assert_close(got, want, True)


@pytest.mark.parametrize("semantics", ["reference", "active_only"])
@pytest.mark.parametrize("n", [3000, 3072, 100])
def test_ragged_fast_stats_equal_the_padded_ones(semantics, n):
    """flash_stats(fast) on N columns equals it on the same layer padded
    with zero columns to the next multiple of 128 and capped there by
    valid_count, cut back to N: z_rel, the tile maxes and m bitwise, s
    within rtol 1e-5 (the sum runs over more, zero, terms) on the rows with
    an active senone; the normalize of the two bitwise.  At N = 3072 the two
    calls are the same call."""
    rng = np.random.default_rng(n)
    b, k, pad = 64, 256, -n % 128
    x = torch.as_tensor(rng.integers(-128, 128, (b, k), dtype=np.int8))
    w = torch.as_tensor(rng.integers(-127, 128, (k, n), dtype=np.int8))
    bias = torch.as_tensor((rng.standard_normal(n) * 0.5).astype(np.float32))
    colsum = 128 * w.to(torch.int32).sum(dim=0, dtype=torch.int32)
    masks = torch.as_tensor((rng.random((b, n)) < 0.4).astype(np.uint8))
    masks[MASKED_FRAME] = 0
    inv = float(np.float32(1.0 / (40 * 255.0)))
    w_p, colsum_p, bias_p, masks_p = (torch.nn.functional.pad(t, (0, pad))
                                      for t in (w, colsum, bias, masks))
    got = tops.flash_stats(x, w, colsum, inv, bias, masks, valid_count=n, semantics=semantics,
                           fast=True)
    ref = tops.flash_stats(x, w_p, colsum_p, inv, bias_p, masks_p, valid_count=n,
                           semantics=semantics, fast=True)
    assert got[0].shape == (b, n) and got[3].shape == (b, -(-n // 128))
    assert torch.equal(got[0], ref[0][:, :n])
    assert torch.equal(got[1], ref[1]) and torch.equal(got[3], ref[3])
    # a row with no active senone (active_only) sums one exp(0) per column
    live = got[1][:, 0] > tops.EMPTY_ROW_MAX
    assert live.sum() == b - (semantics == "active_only")
    torch.testing.assert_close(got[2][live], ref[2][live], rtol=STATS_RTOL, atol=0)
    if n % 128:  # the last tile's max is that of its real columns
        z, _, _ = tops.flash_stats(x, w, colsum, inv, bias, masks, valid_count=n,
                                   semantics=semantics)
        assert torch.equal(got[3][:, -1], z[:, n - n % 128:].amax(dim=1))
    # one s for both, so that the normalize alone is compared
    norm = tops.normalize_stats(*got[:3], out_dim=n, tile_max=got[3])
    assert norm.dtype == torch.bfloat16 and norm.shape == (b, n) and (norm[~live] == 0).all()
    assert torch.equal(norm, tops.normalize_stats(ref[0], ref[1], got[2], out_dim=n,
                                                  tile_max=ref[3]))


def test_fast_stats_on_tile_multiples_are_the_tiles():
    """On a width that is a multiple of 128 (every net the cuda route runs,
    padded to 128 lanes), z_rel is z minus its 128-column tile's max
    rounded once to bf16, and the tile maxes are those tiles' maxes:
    bitwise, as before ragged widths were accepted; the plain route's bf16
    posteriors on such a net are those of the stats so made."""
    rng = np.random.default_rng(5)
    b, k, n = 128, 384, 1024
    x = torch.as_tensor(rng.integers(-128, 128, (b, k), dtype=np.int8))
    w = torch.as_tensor(rng.integers(-127, 128, (k, n), dtype=np.int8))
    bias = torch.as_tensor((rng.standard_normal(n) * 0.5).astype(np.float32))
    colsum = 128 * w.to(torch.int32).sum(dim=0, dtype=torch.int32)
    inv = float(np.float32(1.0 / (30 * 255.0)))
    z, m, s = tops.flash_stats(x, w, colsum, inv, bias, valid_count=1000)
    z_rel, m_f, s_f, tile_max = tops.flash_stats(x, w, colsum, inv, bias, valid_count=1000,
                                                 fast=True)
    tiles = z.view(b, n // 128, 128)
    assert torch.equal(tile_max, tiles.amax(dim=2))
    assert torch.equal(z_rel, (tiles - tile_max[:, :, None]).view(b, n).to(torch.bfloat16))
    assert torch.equal(m_f, m) and torch.equal(s_f, s)
    post = tops.output_posteriors_stats(x, w, colsum, inv, bias, out_dim=1000, fast=True)
    assert torch.equal(post, tops.normalize_stats(z_rel, m, s, out_dim=1000, tile_max=tile_max))


def test_padded_net_fast_posteriors_match_unpadded(nets):
    """The wide net padded to 128 output lanes (as the cuda route pads it)
    and the unpadded one give the same fused fast posteriors on the plain
    route, within bf16's bounds."""
    net = nets["wide"]
    frames = torch.as_tensor(net.frames)
    kw = dict(backend="torch", fused_softmax=True, fast_posteriors=True, out_dim=net.out)
    with torch.inference_mode():
        padded = score_fn(pad_qnet(net.t_q[8], lanes=1, out_lanes=128), frames, **kw)
        unpadded = score_fn(net.t_q[8], frames, **kw)
    assert padded.dtype == unpadded.dtype == torch.bfloat16
    np.testing.assert_allclose(unpadded.float().numpy(), padded.float().numpy(),
                               rtol=BF16_RTOL, atol=BF16_ATOL)


@pytest.mark.parametrize("fused", [False, True], ids=["logits", "fused"])
def test_block_sparse_is_refused_on_the_cpu(nets, fused):
    """lazy_mode="block_sparse" needs the cuda route, as the JAX package's
    needs pallas: both packages refuse it on the CPU."""
    net = nets["narrow"]
    with pytest.raises(ValueError, match="block_sparse"):
        fdt.Scorer(net.t_q[8], fdt.EngineConfig(lazy_mode="block_sparse", fused_softmax=fused),
                   device="cpu")
    with pytest.raises(ValueError, match="block_sparse"):
        fd.Scorer(net.j_q[8], fd.EngineConfig(backend="xla", lazy_mode="block_sparse",
                                              fused_softmax=fused))

"""The port's stats output layer (K8 and its plain versions) and the
wide-net route against the JAX package, on CPU.

The plain versions of the flash-stats kernel (ops.matmul.flash_stats,
block_sparse_stats, output_posteriors_stats,
output_posteriors_block_sparse_stats, reached through the kernel wrappers
with CPU tensors) are held to the Pallas functions they replace in
interpret mode: output_layer_flash_stats (B6), output_layer_posteriors
(B5), output_flash_stats_block_sparse and
output_layer_posteriors_block_sparse (B7).  The Pallas calls take the
kernel's 64 x 128 tile (block_frames=64, block_nodes=128), so tile skipping
and the fast path's tile maxes line up.  Bounds:
  * z within one rounding of the product (XLA's CPU compile fuses the
    multiply and the add; ROADMAP.md section C, tests/test_torch_lazy.py::
    TestOutputLogits); fill and capped entries equal;
  * m and s within rtol 1e-5;
  * posteriors within 3e-5, bf16 posteriors within rtol 2e-2, atol 1e-3.
The gate (engine.scorer.uses_resident_output, build_hidden_stack) and a net
too wide for the resident softmax and the stack kernels are held to JAX's
Scorer taking its own stats fallback.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fastdnn_tpu as fd
import fastdnn_tpu_torch as fdt
from fastdnn_tpu.engine import scorer as jscorer
from fastdnn_tpu.ops import pallas_kernels as pk
from fastdnn_tpu_torch.engine import cuda_backend
from fastdnn_tpu_torch.engine import scorer as tscorer
from fastdnn_tpu_torch.ops import kernels
from fastdnn_tpu_torch.ops import matmul as tops

SOFTMAX_ATOL = 3e-5
STATS_RTOL = 1e-5
POSTERIOR_ATOL = 1e-4
ARGMAX_AGREEMENT = 0.999
BF16_RTOL, BF16_ATOL = 2e-2, 1e-3
SEMANTICS = ["reference", "active_only"]
TILES = dict(block_frames=64, block_nodes=128, interpret=True)
# (B, K, N, out_dim, seed)
SHAPES = [(128, 256, 1024, 1000, 704), (64, 384, 640, 600, 1280)]
SHAPE_IDS = ["128x256x1024", "64x384x640"]


def _layer(b, k, n, out, seed):
    """Seeded int8 activations and weights, colsum128, f32 inv scale and
    bias (columns from `out` on are zero, as padding is), 40% masks with
    a fully masked row, and band masks that leave most tiles inactive."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-128, 128, (b, k), dtype=np.int8)
    w = rng.integers(-127, 128, (k, n), dtype=np.int8)
    bias = (rng.standard_normal(n) * 0.5).astype(np.float32)
    w[:, out:] = 0
    bias[out:] = 0
    colsum = 128 * w.astype(np.int32).sum(axis=0, dtype=np.int32)
    inv = np.float32(1.0 / (rng.integers(20, 60) * 255.0))
    masks = (rng.random((b, n)) < 0.4).astype(np.uint8)
    masks[5] = 0
    bands = np.zeros((b, n), np.uint8)
    for lo in range(0, b, 64):
        start = int(rng.integers(0, out - 100))
        bands[lo:lo + 64, start:start + 100] = rng.random((64, 100)) < 0.5
    bands[5] = 0
    return (x, w, colsum, inv, bias), masks, bands


def _plain_args(x, w, colsum, inv, bias):
    return torch.as_tensor(x), torch.as_tensor(w), torch.as_tensor(colsum), float(inv), \
        torch.as_tensor(bias)


def _wrapper_args(x, w, colsum, inv, bias):
    """The kernel wrappers' operands (weight in the kernels' layout), on the CPU."""
    t = _plain_args(x, w, colsum, inv, bias)
    return (t[0], kernels.kernel_layout(t[1]), *t[2:])


def _assert_stats_close(got, want, args):
    """(z, m, s) of the port against JAX's: z within one rounding of the
    product, m and s within rtol 1e-5."""
    x, w, colsum, inv, bias = args
    z, m, s = (np.asarray(t, dtype=np.float32) for t in got)
    jz, jm, js = (np.asarray(t, dtype=np.float32) for t in want)
    assert z.shape == jz.shape and m.shape == jm.shape == s.shape == js.shape
    prod = (x.astype(np.int64) @ w.astype(np.int64) + colsum).astype(np.float32) * inv
    one_rounding = np.spacing(np.abs(prod)) + np.spacing(np.abs(z))
    assert (np.abs(z - jz) <= one_rounding).all()
    np.testing.assert_allclose(m, jm, rtol=STATS_RTOL, atol=0)
    np.testing.assert_allclose(s, js, rtol=STATS_RTOL, atol=0)


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("mode", ["unmasked", *SEMANTICS])
class TestFlashStats:
    """B6, output_layer_flash_stats: logits and unnormalized stats with a
    runtime valid count (a tensor-parallel shard's cutoff)."""

    @pytest.mark.parametrize("valid", ["out", "half", "zero"])
    def test_matches_pallas(self, shape, mode, valid):
        b, k, n, out, seed = shape
        args, masks, _ = _layer(*shape)
        count = {"out": out, "half": n // 2, "zero": 0}[valid]
        m = None if mode == "unmasked" else masks
        sem = "reference" if mode == "unmasked" else mode
        want = pk.output_layer_flash_stats(
            *args, None if m is None else jnp.asarray(m), valid_count=jnp.int32(count),
            semantics=sem, **TILES)
        got = kernels.flash_stats(*_wrapper_args(*args), None if m is None else torch.as_tensor(m),
                                  valid_count=count, semantics=sem)
        _assert_stats_close(got, want, args)
        z = got[0].numpy()
        assert (z[:, count:] == -1e30).all()
        if mode == "active_only":
            assert (z[:, :count][masks[:, :count] == 0] == -1e30).all()

    def test_fast_tile_maxes(self, shape, mode):
        """fast: bf16 z minus its 128-column tile max, and the tile maxes:
        z rebuilt from them is the f32 z within one bf16 rounding of its
        distance to the tile max."""
        args, masks, _ = _layer(*shape)
        out = shape[3]
        m = None if mode == "unmasked" else torch.as_tensor(masks)
        sem = "reference" if mode == "unmasked" else mode
        z, mx, s = tops.flash_stats(*_plain_args(*args), m, valid_count=out, semantics=sem)
        z_rel, mx2, s2, tile_max = tops.flash_stats(*_plain_args(*args), m, valid_count=out,
                                                    semantics=sem, fast=True)
        assert z_rel.dtype == torch.bfloat16 and tile_max.shape == (shape[0], shape[2] // 128)
        assert torch.equal(mx, mx2) and torch.equal(s, s2)
        torch.testing.assert_close(tile_max, z.view(shape[0], -1, 128).amax(dim=2), rtol=0,
                                   atol=0)
        tile_max_cols = tile_max.repeat_interleave(128, dim=1)
        live = z > -1e29
        # bf16 rounds z - tile max: the error is relative to that distance
        err = (z_rel.float() + tile_max_cols - z).abs()
        assert (err[live] <= (z - tile_max_cols).abs()[live] * 2 ** -8 + 1e-6).all()


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
class TestOutputPosteriorsStats:
    """B5, output_layer_posteriors: the stats and the normalize, with the
    all-masked zero row, f32 and bf16."""

    @pytest.mark.parametrize("mode", ["unmasked", *SEMANTICS])
    def test_matches_pallas(self, shape, mode):
        b, k, n, out, seed = shape
        args, masks, _ = _layer(*shape)
        m = None if mode == "unmasked" else masks
        sem = "reference" if mode == "unmasked" else mode
        want = np.asarray(pk.output_layer_posteriors(
            *args, None if m is None else jnp.asarray(m), out_dim=out, semantics=sem, **TILES))
        tm = None if m is None else torch.as_tensor(m)
        plain = tops.output_posteriors_stats(*_plain_args(*args), tm, out_dim=out, semantics=sem)
        # the CUDA backend's route, its kernel wrapper dispatching to the plain version
        routed = cuda_backend.output_posteriors(*_wrapper_args(*args), tm, out_dim=out,
                                                semantics=sem)
        torch.testing.assert_close(routed, plain, rtol=0, atol=0)
        got = plain.numpy()
        assert got.shape == (b, out) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=SOFTMAX_ATOL)
        np.testing.assert_array_equal(got.argmax(1), want.argmax(1))
        # the resident softmax's plain version computes the same function
        resident = tops.output_posteriors(*_plain_args(*args), tm, out_dim=out, semantics=sem)
        np.testing.assert_allclose(got, resident.numpy(), rtol=0, atol=SOFTMAX_ATOL)
        if mode == "active_only":
            np.testing.assert_array_equal(got[5], 0.0)
            assert (got[masks[:, :out] == 0] == 0).all()

    @pytest.mark.parametrize("mode", ["unmasked", "reference"])
    def test_fast_bf16(self, shape, mode):
        b, k, n, out, seed = shape
        args, masks, _ = _layer(*shape)
        m = None if mode == "unmasked" else masks
        want = np.asarray(pk.output_layer_posteriors(
            *args, None if m is None else jnp.asarray(m), out_dim=out, fast=True,
            **TILES).astype(jnp.float32))
        f32 = tops.output_posteriors_stats(*_plain_args(*args), None if m is None
                                           else torch.as_tensor(m), out_dim=out)
        got = tops.output_posteriors_stats(*_plain_args(*args), None if m is None
                                           else torch.as_tensor(m), out_dim=out, fast=True)
        assert got.dtype == torch.bfloat16 and got.shape == (b, out)
        np.testing.assert_allclose(got.float().numpy(), want, rtol=BF16_RTOL, atol=BF16_ATOL)
        np.testing.assert_allclose(got.float().numpy(), f32.numpy(), rtol=BF16_RTOL,
                                   atol=BF16_ATOL)


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("semantics", SEMANTICS)
class TestBlockSparseStats:
    """B7: the skipping stats kernel's plain version against
    output_flash_stats_block_sparse and output_layer_posteriors_block_sparse."""

    @pytest.mark.parametrize("masks_kind", ["bands", "all_inactive"])
    @pytest.mark.parametrize("capped_fill", [False, True], ids=["fill", "capped"])
    def test_stats_match_pallas(self, shape, semantics, masks_kind, capped_fill):
        b, k, n, out, seed = shape
        args, _, bands = _layer(*shape)
        masks = bands if masks_kind == "bands" else np.zeros_like(bands)
        count = n // 2 if capped_fill else out
        got = kernels.flash_stats_block_sparse(
            *_wrapper_args(*args), torch.as_tensor(masks), valid_count=count,
            semantics=semantics, capped_fill=capped_fill)
        if capped_fill:
            want = pk.output_flash_stats_block_sparse(
                *args, jnp.asarray(masks), valid_count=jnp.int32(count), semantics=semantics,
                **TILES)
        else:  # the posteriors' call: capped_fill=False, valid_count = out_dim
            want = pk._block_sparse_stats_call(
                *args, jnp.asarray(masks), valid_count=count, semantics=semantics,
                capped_fill=False, **TILES)
            want = (want[0], want[1][:, :1], want[2][:, :1])
        _assert_stats_close(got, want, args)
        active = tops.tile_activity(torch.as_tensor(masks))
        if masks_kind == "all_inactive":
            assert not active.any()
            m = got[1].numpy()
            np.testing.assert_array_equal(m, np.float32(0.0 if semantics == "reference" else -1e30))
        else:
            assert 0 < float(active.float().mean()) < 0.5  # most tiles are skipped

    def test_posteriors_match_pallas(self, shape, semantics):
        b, k, n, out, seed = shape
        args, _, bands = _layer(*shape)
        want = np.asarray(pk.output_layer_posteriors_block_sparse(
            *args, jnp.asarray(bands), out_dim=out, semantics=semantics, **TILES))
        got = tops.output_posteriors_block_sparse_stats(
            *_plain_args(*args), torch.as_tensor(bands), out_dim=out, semantics=semantics)
        routed = cuda_backend.output_posteriors_block_sparse(
            *_wrapper_args(*args), torch.as_tensor(bands), out_dim=out, semantics=semantics,
            resident=False)
        torch.testing.assert_close(routed, got, rtol=0, atol=0)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=SOFTMAX_ATOL)
        dense = tops.output_posteriors(*_plain_args(*args), torch.as_tensor(bands), out_dim=out,
                                       semantics=semantics)
        np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=0, atol=SOFTMAX_ATOL)
        if semantics == "active_only":
            np.testing.assert_array_equal(got[5].numpy(), 0.0)


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
class TestNormalizeStats:
    """K8's normalize wrapper (kernels.normalize_stats, its plain version on
    the CPU) after the stats wrappers, against the Pallas posteriors it
    replaces the fused XLA pass of: out_dim below N, the all-masked
    active_only row exactly 0."""

    @pytest.mark.parametrize("mode", ["unmasked", *SEMANTICS])
    def test_matches_pallas(self, shape, mode):
        b, k, n, out, seed = shape
        args, masks, _ = _layer(*shape)
        m = None if mode == "unmasked" else masks
        sem = "reference" if mode == "unmasked" else mode
        want = np.asarray(pk.output_layer_posteriors(
            *args, None if m is None else jnp.asarray(m), out_dim=out, semantics=sem, **TILES))
        z, mx, s = kernels.flash_stats(*_wrapper_args(*args),
                                       None if m is None else torch.as_tensor(m),
                                       valid_count=out, semantics=sem)
        got = kernels.normalize_stats(z, mx, s, out_dim=out)
        assert got.shape == (b, out) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=SOFTMAX_ATOL)
        if mode == "active_only":
            np.testing.assert_array_equal(got[5].numpy(), 0.0)

    @pytest.mark.parametrize("mode", ["unmasked", "reference"])
    def test_fast_matches_pallas(self, shape, mode):
        b, k, n, out, seed = shape
        args, masks, _ = _layer(*shape)
        m = None if mode == "unmasked" else masks
        want = np.asarray(pk.output_layer_posteriors(
            *args, None if m is None else jnp.asarray(m), out_dim=out, fast=True,
            **TILES).astype(jnp.float32))
        z_rel, mx, s, tile_max = kernels.flash_stats(
            *_wrapper_args(*args), None if m is None else torch.as_tensor(m), valid_count=out,
            fast=True)
        got = kernels.normalize_stats(z_rel, mx, s, out_dim=out, tile_max=tile_max)
        assert got.shape == (b, out) and got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(), want, rtol=BF16_RTOL, atol=BF16_ATOL)

    @pytest.mark.parametrize("semantics", SEMANTICS)
    def test_block_sparse_matches_pallas(self, shape, semantics):
        b, k, n, out, seed = shape
        args, _, bands = _layer(*shape)
        want = np.asarray(pk.output_layer_posteriors_block_sparse(
            *args, jnp.asarray(bands), out_dim=out, semantics=semantics, **TILES))
        z, mx, s = kernels.flash_stats_block_sparse(
            *_wrapper_args(*args), torch.as_tensor(bands), valid_count=out, semantics=semantics)
        got = kernels.normalize_stats(z, mx, s, out_dim=out).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=SOFTMAX_ATOL)
        if semantics == "active_only":
            np.testing.assert_array_equal(got[5], 0.0)

    def test_all_capped_rows_are_zero(self, shape):
        """valid_count 0: every column capped, every row's max at -1e30."""
        b, k, n, out, seed = shape
        args, _, _ = _layer(*shape)
        z, mx, s = kernels.flash_stats(*_wrapper_args(*args), valid_count=0)
        assert (mx.numpy() == np.float32(-1e30)).all()
        got = kernels.normalize_stats(z, mx, s, out_dim=out)
        np.testing.assert_array_equal(got.numpy(), 0.0)


def _merge(a, b):
    """rowstats::merge_stats on rows of (m, s) pairs: a pair that saw no
    column (-inf, 0) leaves the other as it is."""
    (am, a_s), (bm, b_s) = a, b
    mm = np.maximum(am, bm)
    with np.errstate(invalid="ignore"):
        both = a_s * np.exp(am - mm) + b_s * np.exp(bm - mm)
    m = np.where(bm == -np.inf, am, np.where(am == -np.inf, bm, mm))
    s = np.where(bm == -np.inf, a_s, np.where(am == -np.inf, b_s, both))
    return m.astype(np.float32), s.astype(np.float32)


def _k8_fold(z, valid_count, semantics="reference", active=None):
    """(m, s) [B, 1] from logits z [B, N] in K8's fold order
    (csrc/flash_stats.cu): per 64-frame block, the two blocks of a pair take
    the first and second half of the column tiles (rowstats::ColumnPart),
    the two consumer warpgroups of a block take alternate tiles of its list
    (every tile, or with `active` [B / 64, N / 128] the active ones), each
    folding its tiles online; the warpgroups' pairs merge, then (skipping,
    under reference) the block's skipped valid columns as the pair
    (0, count), then the blocks in rank order; m is floored at -1e30."""
    z = np.asarray(z, np.float32)
    b, n = z.shape
    tiles = n // 128
    per = -(-tiles // 2)
    parts = [(g0, min(tiles, g0 + per)) for g0 in (0, per)]
    m_out = np.empty((b, 1), np.float32)
    s_out = np.empty((b, 1), np.float32)
    empty = (np.full(64, -np.inf, np.float32), np.zeros(64, np.float32))
    for r0 in range(0, b, 64):
        rows = z[r0:r0 + 64]
        total = empty
        for g0, g1 in parts:
            listed = [g for g in range(g0, g1) if active is None or active[r0 // 64, g]]
            pairs = []
            for w in range(2):
                m, s = empty
                for g in listed[w::2]:
                    t = rows[:, g * 128:(g + 1) * 128]
                    m_new = np.maximum(m, t.max(axis=1))
                    e = np.exp(t - m_new[:, None]).sum(axis=1, dtype=np.float32)
                    s = (s * np.exp(m - m_new) + e).astype(np.float32)
                    m = m_new
                pairs.append((m, s))
            block = _merge(*pairs)
            if active is not None and semantics == "reference":
                skipped = sum(min(max(valid_count - g * 128, 0), 128)
                              for g in range(g0, g1) if not active[r0 // 64, g])
                if skipped:
                    block = _merge(block, (np.zeros(64, np.float32),
                                           np.full(64, skipped, np.float32)))
            total = _merge(total, block)
        m_out[r0:r0 + 64, 0] = np.maximum(total[0], np.float32(-1e30))
        s_out[r0:r0 + 64, 0] = total[1]
    return m_out, s_out


# 33 column tiles: the pair splits them 17 / 16, and the warpgroups of a
# block take 9 / 8 and 8 / 8
FOLD_SHAPE = (128, 128, 4224, 4100, 4224)


class TestFoldOrder:
    """A CPU model of K8's fold order (_k8_fold) on the Pallas stats
    kernels' own logits, in interpret mode: m bitwise, s within rtol 1e-5,
    for valid counts N, 4096 and 0, dense and skipping under both
    semantics; and on the plain version's logits against its (m, s)."""

    @pytest.mark.parametrize("valid", [4224, 4096, 0])
    @pytest.mark.parametrize("mode", ["unmasked", *SEMANTICS])
    def test_dense_fold_matches_pallas(self, mode, valid):
        args, masks, _ = _layer(*FOLD_SHAPE)
        m = None if mode == "unmasked" else masks
        sem = "reference" if mode == "unmasked" else mode
        jz, jm, js = (np.asarray(t) for t in pk.output_layer_flash_stats(
            *args, None if m is None else jnp.asarray(m), valid_count=jnp.int32(valid),
            semantics=sem, **TILES))
        m_model, s_model = _k8_fold(jz, valid, sem)
        np.testing.assert_array_equal(m_model, jm)
        np.testing.assert_allclose(s_model, js, rtol=STATS_RTOL, atol=0)
        z, pm, ps = kernels.flash_stats(*_wrapper_args(*args),
                                        None if m is None else torch.as_tensor(m),
                                        valid_count=valid, semantics=sem)
        m_model, s_model = _k8_fold(z.numpy(), valid, sem)
        np.testing.assert_array_equal(m_model, pm.numpy())
        np.testing.assert_allclose(s_model, ps.numpy(), rtol=STATS_RTOL, atol=0)

    @pytest.mark.parametrize("valid", [4224, 4096, 0])
    @pytest.mark.parametrize("semantics", SEMANTICS)
    def test_skipping_fold_matches_pallas(self, semantics, valid):
        args, _, bands = _layer(*FOLD_SHAPE)
        jz, jm, js = (np.asarray(t) for t in pk.output_flash_stats_block_sparse(
            *args, jnp.asarray(bands), valid_count=jnp.int32(valid), semantics=semantics,
            **TILES))
        active = tops.tile_activity(torch.as_tensor(bands)).numpy()
        assert 0 < active.mean() < 0.5  # most tiles are skipped
        m_model, s_model = _k8_fold(jz, valid, semantics, active)
        np.testing.assert_array_equal(m_model, jm)
        np.testing.assert_allclose(s_model, js, rtol=STATS_RTOL, atol=0)
        z, pm, ps = kernels.flash_stats_block_sparse(
            *_wrapper_args(*args), torch.as_tensor(bands), valid_count=valid,
            semantics=semantics, capped_fill=True)
        m_model, s_model = _k8_fold(z.numpy(), valid, semantics, active)
        np.testing.assert_array_equal(m_model, pm.numpy())
        np.testing.assert_allclose(s_model, ps.numpy(), rtol=STATS_RTOL, atol=0)


def _normalize_operands(fast=False):
    rng = np.random.default_rng(21)
    z = torch.as_tensor(rng.standard_normal((64, 256)).astype(np.float32))
    m, s = z.amax(dim=1, keepdim=True), torch.ones((64, 1))
    if fast:
        return z.to(torch.bfloat16), m, s, torch.zeros((64, 2))
    return z, m, s, None


@pytest.mark.parametrize("case,match", [
    ("z f64", "expected torch.float32"),
    ("z 1-d", r"z must be \[B, N\]"),
    ("m [B]", "expected shape"),
    ("s int32", "expected torch.float32"),
    ("fast z f32", "expected torch.bfloat16"),
    ("tile_max shape", "expected shape"),
    ("fast N not a tile multiple", "multiple of 128"),
    ("out_dim 0", "out_dim=0"),
    ("out_dim past N", "out_dim=257"),
])
def test_normalize_stats_refusals(case, match):
    """The normalize wrapper refuses wrong dtypes and shapes on every
    device, before it dispatches."""
    z, m, s, tile_max = _normalize_operands(fast=case.startswith(("fast", "tile_max")))
    out_dim = 200
    if case == "z f64":
        z = z.double()
    elif case == "z 1-d":
        z = z[0]
    elif case == "m [B]":
        m = m[:, 0]
    elif case == "s int32":
        s = s.int()
    elif case == "fast z f32":
        z = z.float()
    elif case == "tile_max shape":
        tile_max = tile_max[:, :1]
    elif case == "fast N not a tile multiple":
        z, tile_max = z[:, :200], tile_max[:, :1]
        out_dim = 100
    elif case == "out_dim 0":
        out_dim = 0
    elif case == "out_dim past N":
        out_dim = 257
    with pytest.raises(ValueError, match=match):
        kernels.normalize_stats(z, m, s, out_dim=out_dim, tile_max=tile_max)


def _qnet(widths, out=64, seed=0, input_dim=32):
    return fdt.quantize_net(fdt.random_net(np.random.default_rng(seed), input_dim, widths, out))


class TestGate:
    """Which output kernel and trunk kernel a net gets, from the kernels'
    shared-memory limits."""

    @pytest.mark.parametrize("k,resident", [(2048, True), (2176, False)])
    def test_resident_output_flips_past_2048(self, k, resident):
        net = _qnet([k])
        assert kernels.RESIDENT_SOFTMAX_MAX_K == 2048
        assert tscorer.uses_resident_output(net) is resident
        assert tscorer.uses_resident_output(net, block_sparse=True) is resident
        # the same answer in the kernels' weight layout
        assert tscorer.uses_resident_output(cuda_backend.prepare(net)) is resident

    @pytest.mark.parametrize("h,stacked", [(2304, True), (2432, False)])
    def test_hidden_stack_only_up_to_2304(self, h, stacked):
        net = _qnet([h, h, h])
        assert kernels.HIDDEN_STACK_MAX_H == 2304
        assert (fdt.build_hidden_stack(net) is not None) is stacked


class TestWideNet:
    """A 432 -> 2x2432 -> 1000 net: no hidden stack (H = 2432) and an
    output layer too wide for the resident softmax.  The port routes it to
    the stats kernel's plain version and the per-layer trunk; JAX's Scorer
    takes its own stats fallback when the resident gate is closed (patched
    here, as tests/test_kernels.py does)."""

    @pytest.fixture(scope="class")
    def wide(self, tmp_path_factory):
        t_net = fdt.random_net(np.random.default_rng(2432), 432, [2432, 2432], 1000)
        j_q = fd.quantize_net(fd.from_raw(fdt.to_raw(t_net)))
        path = tmp_path_factory.mktemp("wide") / "q.npz"
        fd.save_qnet(j_q, path)
        return j_q, fdt.load_qnet(path)

    @pytest.mark.parametrize("semantics", [None, *SEMANTICS], ids=["score", *SEMANTICS])
    def test_stats_route_matches_jax_fallback(self, wide, semantics, monkeypatch):
        j_q, t_q = wide
        rng = np.random.default_rng(7)
        frames = rng.standard_normal((200, 432), dtype=np.float32)
        masks = (rng.random((200, 1000)) < 0.4).astype(np.uint8)
        masks[3] = 0
        monkeypatch.setattr(jscorer, "RESIDENT_OUTPUT_MAX_BYTES", 0)
        j_sc = fd.Scorer(j_q, fd.EngineConfig(backend="pallas", interpret=True,
                                              lazy_semantics=semantics or "reference"))
        assert not jscorer.uses_resident_output(j_sc.net)
        calls = []
        stats = tops.output_posteriors_stats
        monkeypatch.setattr(tops, "output_posteriors_stats",
                            lambda *a, **kw: calls.append(1) or stats(*a, **kw))
        monkeypatch.setattr(tops, "output_posteriors",
                            lambda *a, **kw: pytest.fail("the resident route ran"))
        t_sc = fdt.Scorer(t_q, fdt.EngineConfig(lazy_semantics=semantics or "reference"),
                          device="cpu")
        assert t_sc._hstack is None and not tscorer.uses_resident_output(t_sc.net)
        if semantics is None:
            got, want = t_sc.score(frames), j_sc.score(frames)
        else:
            got, want = t_sc.score_masked(frames, masks), j_sc.score_masked(frames, masks)
        assert calls == [1]
        assert got.shape == want.shape == (200, 1000) and got.dtype == np.float32
        assert np.isfinite(got).all()
        assert np.abs(got - want).max() <= POSTERIOR_ATOL
        assert (got.argmax(1) == want.argmax(1)).mean() >= ARGMAX_AGREEMENT
        if semantics == "active_only":
            np.testing.assert_array_equal(got[3], 0.0)


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs the same checks on the card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("semantics", SEMANTICS)
def test_stats_kernels_match_plain_versions_on_card(cuda_device, semantics):
    """K8 (unmasked, masked, fast, skipping with and without capped_fill) and
    its normalize against their plain versions on the card: z, m and the
    tile maxes bitwise, s within rtol 1e-5, posteriors within 3e-5 (bf16:
    rtol 2e-2, atol 1e-3).  B = 192 (three pairs of blocks), N = 640 (five
    tiles: the pair splits them 3 / 2)."""
    b, k, n, out = 192, 256, 640, 600
    args, masks, bands = _layer(b, k, n, out, 640)
    x, w_t, colsum, inv, bias = (t.to(cuda_device) if isinstance(t, torch.Tensor) else t
                                 for t in _wrapper_args(*args))
    w = w_t.t()
    masks, bands = torch.as_tensor(masks).to(cuda_device), torch.as_tensor(bands).to(cuda_device)

    def same_stats(got, want):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        torch.testing.assert_close(got[2], want[2], rtol=STATS_RTOL, atol=0)

    for valid in (out, n // 2, 0):
        for m in (None, masks):
            got = kernels.flash_stats(x, w_t, colsum, inv, bias, m, valid_count=valid,
                                      semantics=semantics)
            same_stats(got, tops.flash_stats(x, w, colsum, inv, bias, m, valid_count=valid,
                                             semantics=semantics))
            p = kernels.normalize_stats(*got, out_dim=out)
            torch.testing.assert_close(p, tops.normalize_stats(*got, out_dim=out), rtol=0,
                                       atol=SOFTMAX_ATOL)
        for capped in (False, True):
            got = kernels.flash_stats_block_sparse(x, w_t, colsum, inv, bias, bands,
                                                   valid_count=valid, semantics=semantics,
                                                   capped_fill=capped)
            same_stats(got, tops.block_sparse_stats(x, w, colsum, inv, bias, bands,
                                                    valid_count=valid, semantics=semantics,
                                                    capped_fill=capped))
    got = kernels.flash_stats(x, w_t, colsum, inv, bias, masks, valid_count=out,
                              semantics=semantics, fast=True)
    want = tops.flash_stats(x, w, colsum, inv, bias, masks, valid_count=out, semantics=semantics,
                            fast=True)
    same_stats(got, want)
    assert torch.equal(got[3], want[3])
    p = kernels.normalize_stats(*got[:3], out_dim=out, tile_max=got[3])
    assert p.dtype == torch.bfloat16
    torch.testing.assert_close(p.float(), tops.normalize_stats(
        *got[:3], out_dim=out, tile_max=got[3]).float(), rtol=BF16_RTOL, atol=BF16_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("semantics", SEMANTICS)
def test_skipping_stats_past_k6_width_on_card(cuda_device, semantics):
    """K8's skipping variant lists up to 8192 column tiles per block of a
    pair: at N = 131,456 each block takes 514 tiles, past the 256 of K6's
    list.  z and m bitwise and s within rtol 1e-5 of its plain version."""
    b, k, n, out = 128, 128, 2 * 65536 + 3 * 128, 131000
    assert n <= kernels.FLASH_STATS_MAX_SKIP_N
    args, _, bands = _layer(b, k, n, out, 131)
    x, w_t, colsum, inv, bias = (t.to(cuda_device) if isinstance(t, torch.Tensor) else t
                                 for t in _wrapper_args(*args))
    bands = torch.as_tensor(bands).to(cuda_device)
    for capped, valid in ((False, n), (True, out)):
        got = kernels.flash_stats_block_sparse(x, w_t, colsum, inv, bias, bands,
                                               valid_count=valid, semantics=semantics,
                                               capped_fill=capped)
        want = tops.block_sparse_stats(x, w_t.t(), colsum, inv, bias, bands, valid_count=valid,
                                       semantics=semantics, capped_fill=capped)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        torch.testing.assert_close(got[2], want[2], rtol=STATS_RTOL, atol=0)

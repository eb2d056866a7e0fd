"""The port's lazy path against the JAX package, on CPU.

The plain versions of the masked resident softmax (K4), the output logits
(K5) and the block-sparse resident softmax (K6) are held to the JAX
package's Pallas kernels in interpret mode and its XLA ops; the lazy entry
points (`Scorer.score_masked`, `LazyContext`, the gathered and block-sparse
modes, the senone clustering, the beam decoder and the CLI) are held to the
JAX package's.  Bounds:
  * from identical int8 activations: posteriors within 3e-5 (softmax
    reduction order); logits within one rounding of the product (XLA's
    CPU compile fuses the multiply and the add, TestOutputLogits);
  * from frames: posteriors within 1e-4 with at least 99.9% argmax
    agreement (the float input layer may flip a rare first-layer count);
  * bf16 posteriors: rtol 2e-2, atol 1e-3 against f32 ones, as the JAX
    package holds its own bf16 kernel.
"""

import concurrent.futures
import os
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fastdnn_tpu as fd
import fastdnn_tpu_torch as fdt
from fastdnn_tpu.cli import score as jcli
from fastdnn_tpu.decoder import BeamDecoder as JBeamDecoder
from fastdnn_tpu.decoder import random_lexicon as j_random_lexicon
from fastdnn_tpu.engine import cluster as jcluster
from fastdnn_tpu.engine import lazy as jlazy
from fastdnn_tpu.ops import matmul as jops
from fastdnn_tpu.ops import pallas_kernels as pk
from fastdnn_tpu_torch.cli import score as tcli
from fastdnn_tpu_torch.engine import cluster as tcluster
from fastdnn_tpu_torch.engine import lazy as tlazy
from fastdnn_tpu_torch.engine.backend import KERNELS, PLAIN, output_layer
from fastdnn_tpu_torch.engine.scorer import Route, score_masked_fn
from fastdnn_tpu_torch.ops import kernels
from fastdnn_tpu_torch.ops import matmul as tops

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOFTMAX_ATOL = 3e-5
POSTERIOR_ATOL = 1e-4
ARGMAX_AGREEMENT = 0.999
SEMANTICS = ["reference", "active_only"]


def _layer(rng, b, k, n, out_dim=None):
    """Seeded int8 activations, int8 weights, colsum128, f32 inv scale and
    bias, as numpy; columns from `out_dim` on are zero, as padding is."""
    x = rng.integers(-128, 128, (b, k), dtype=np.int8)
    w = rng.integers(-127, 128, (k, n), dtype=np.int8)
    bias = (rng.standard_normal(n) * 0.5).astype(np.float32)
    if out_dim is not None:
        w[:, out_dim:] = 0
        bias[out_dim:] = 0
    colsum = 128 * w.astype(np.int32).sum(axis=0, dtype=np.int32)
    inv = np.float32(1.0 / (rng.integers(20, 60) * 255.0))
    return x, w, colsum, inv, bias


def _wrapper_args(x, w, colsum, inv, bias):
    """The kernel wrappers' operands (weight in kernel layout), on the CPU."""
    return (torch.as_tensor(x), kernels.kernel_layout(torch.as_tensor(w)),
            torch.as_tensor(colsum), float(inv), torch.as_tensor(bias))


def _nets(seed, out):
    """(port float net, JAX float net) with identical weights."""
    t_net = fdt.random_net(np.random.default_rng(seed), 432, [256, 256, 256], out)
    return t_net, fd.from_raw(fdt.to_raw(t_net))


def _carry(j_q, tmp_path):
    """A JAX QuantizedNet -> the port, through the checkpoint arrays."""
    fd.save_qnet(j_q, tmp_path / "q.npz")
    with np.load(tmp_path / "q.npz") as z:
        return fdt.qnet_from_arrays({k: np.asarray(z[k]) for k in z.files})


def _frames(seed, n):
    return np.random.default_rng(seed).standard_normal((n, 432), dtype=np.float32)


def _masks(seed, n, out, density=0.4):
    masks = (np.random.default_rng(seed).random((n, out)) < density).astype(np.uint8)
    masks[3] = 0  # a frame with no active senone
    return masks


def _assert_close_posteriors(got, want):
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= POSTERIOR_ATOL
    assert (got.argmax(1) == want.argmax(1)).mean() >= ARGMAX_AGREEMENT


@pytest.fixture(scope="module", params=[400, 1000])
def nets(request, tmp_path_factory):
    _, j_net = _nets(request.param, request.param)
    j_q = fd.quantize_net(j_net)
    return j_q, _carry(j_q, tmp_path_factory.mktemp("q"))


class TestMaskedResidentSoftmax:
    """K4's masked branch and bf16 output, through the wrapper on CPU."""

    @pytest.mark.parametrize("semantics", SEMANTICS)
    def test_matches_pallas_and_xla(self, semantics):
        rng = np.random.default_rng(11)
        out_dim = 1000
        args = _layer(rng, 128, 256, 1024, out_dim)
        x, w, colsum, inv, bias = args
        masks = (rng.random((128, 1024)) < 0.4).astype(np.uint8)
        masks[5] = 0  # fully masked row
        masks[:, out_dim:] = rng.integers(0, 2, (128, 1024 - out_dim))  # padding never counts
        pallas = np.asarray(pk.output_layer_posteriors_resident(
            *args, jnp.asarray(masks), out_dim=out_dim, semantics=semantics, interpret=True
        ))
        cut = (x, w[:, :out_dim], colsum[:out_dim], inv, bias[:out_dim])
        xla = np.asarray(jax.jit(jops.masked_output_step, static_argnames="semantics")(
            *cut, masks[:, :out_dim] != 0, semantics=semantics
        ))
        ours = kernels.resident_softmax(*_wrapper_args(*args), torch.as_tensor(masks),
                                        out_dim=out_dim, semantics=semantics).numpy()
        step = tops.masked_output_step(*(torch.as_tensor(a) for a in cut),
                                       torch.as_tensor(masks[:, :out_dim] != 0),
                                       semantics=semantics).numpy()
        assert ours.shape == (128, out_dim) and ours.dtype == np.float32
        for want in (pallas, xla, step):
            np.testing.assert_allclose(ours, want, rtol=0, atol=SOFTMAX_ATOL)
            np.testing.assert_array_equal(ours.argmax(1), want.argmax(1))
        if semantics == "active_only":
            assert (ours[5] == 0).all() and (pallas[5] == 0).all()
            assert (ours[masks[:, :out_dim] == 0] == 0).all()
        else:
            np.testing.assert_allclose(ours[5], 1.0 / out_dim, rtol=1e-5)

    def test_fast_bf16(self):
        rng = np.random.default_rng(12)
        args = _layer(rng, 128, 256, 640, 600)
        masks = (rng.random((128, 640)) < 0.4).astype(np.uint8)
        for m in (None, masks):
            jm = None if m is None else jnp.asarray(m)
            tm = None if m is None else torch.as_tensor(m)
            full = np.asarray(pk.output_layer_posteriors_resident(
                *args, jm, out_dim=600, interpret=True))
            pallas_fast = np.asarray(pk.output_layer_posteriors_resident(
                *args, jm, out_dim=600, interpret=True, fast=True), np.float32)
            fast = kernels.resident_softmax(*_wrapper_args(*args), tm, out_dim=600, fast=True)
            assert fast.dtype == torch.bfloat16 and fast.shape == (128, 600)
            fast = fast.float().numpy()
            np.testing.assert_allclose(fast, full, rtol=2e-2, atol=1e-3)
            np.testing.assert_allclose(fast, pallas_fast, rtol=2e-2, atol=1e-3)

    def test_unknown_semantics_raises(self):
        rng = np.random.default_rng(13)
        x, w, colsum, inv, bias = _wrapper_args(*_layer(rng, 64, 128, 128))
        masks = torch.ones((64, 128), dtype=torch.uint8)
        with pytest.raises(ValueError, match="semantics"):
            kernels.resident_softmax(x, w, colsum, inv, bias, masks, out_dim=128,
                                     semantics="bogus")
        with pytest.raises(ValueError, match="semantics"):
            jops.masked_output_step(*_layer(rng, 8, 128, 128), np.ones((8, 128), bool),
                                    semantics="bogus")


class TestOutputLogits:
    """K5's plain version against the Pallas logits kernel and the jitted
    XLA op.  Found: XLA's CPU compile contracts `f * inv_scale + bias` into
    one FMA (both JAX results equal the once-rounded value), while the port
    rounds after the multiply and after the add, as its kernels do (built
    with -fmad=false).  So the port is bitwise the twice-rounded value and
    differs from JAX by the product's rounding: at most 1 ulp of the
    product plus 1 ulp of the result."""

    @pytest.mark.parametrize("b,k,n", [(64, 256, 384), (128, 128, 1024)])
    def test_bitwise_twice_rounded_and_1_ulp_of_jax(self, b, k, n):
        rng = np.random.default_rng(b + k + n)
        args = _layer(rng, b, k, n)
        x, w, colsum, inv, bias = args
        pallas = np.asarray(pk.output_layer_logits(*args, interpret=True))
        xla = np.asarray(jax.jit(jops.output_logits)(*args))
        ours = kernels.output_logits(*_wrapper_args(*args)).numpy()
        assert ours.shape == (b, n) and ours.dtype == np.float32
        f = (x.astype(np.int64) @ w.astype(np.int64) + colsum).astype(np.float32)
        np.testing.assert_array_equal(ours, f * inv + bias)  # numpy rounds each op
        fused = (f.astype(np.float64) * np.float64(inv) + bias).astype(np.float32)
        np.testing.assert_array_equal(xla, fused)
        np.testing.assert_array_equal(pallas, fused)
        one_ulp = np.spacing(np.abs(f * inv)) + np.spacing(np.abs(ours))
        assert (np.abs(ours - xla) <= one_ulp).all()


LAZY_OUT = 3000  # not a multiple of the kernels' 128-column tile


@pytest.fixture(scope="module")
def lazy_nets(tmp_path_factory):
    """(JAX QuantizedNet, the port's, the port's padded and prepared for
    the CUDA backend) of a 432 -> 3x256 -> 3000 net."""
    _, j_net = _nets(41, LAZY_OUT)
    j_q = fd.quantize_net(j_net)
    t_q = _carry(j_q, tmp_path_factory.mktemp("lazy_out"))
    return j_q, t_q, KERNELS.prepare(t_q, "cpu")


def _lazy_masks(kind, rows, width, seed):
    if kind == "inactive":
        return np.zeros((rows, width), np.uint8)
    if kind == "active":
        return np.ones((rows, width), np.uint8)
    return (np.random.default_rng(seed).random((rows, width)) < 0.4).astype(np.uint8)


class TestLazyOutput:
    """The one-launch lazy output (ops.kernels.lazy_output) through its
    plain route and through the kernels' Route.masked_from_acts on CPU tensors,
    against the JAX package's _masked_from_acts_fn (the logits op, then
    the masked softmax in XLA) on the same int8 activations: within 3e-5."""

    @pytest.mark.parametrize("kind", ["inactive", "active", "40%"])
    @pytest.mark.parametrize("rows", [1, 2, 4])
    @pytest.mark.parametrize("semantics", SEMANTICS)
    def test_matches_jax_masked_from_acts(self, lazy_nets, semantics, rows, kind):
        j_q, _, prepared = lazy_nets
        rng = np.random.default_rng(rows)
        acts = rng.integers(-128, 128, (rows, 256), dtype=np.int8)
        masks = _lazy_masks(kind, rows, LAZY_OUT, rows + 7)
        want = np.asarray(fd.Scorer._masked_from_acts_fn(
            j_q, jnp.asarray(acts), jnp.asarray(masks), backend="xla", interpret=False,
            semantics=semantics, out_dim=LAZY_OUT))
        got_acts, got_masks = torch.as_tensor(acts), torch.as_tensor(masks)
        routed = Route(KERNELS, LAZY_OUT, semantics=semantics).masked_from_acts(
            prepared, got_acts, got_masks).numpy()
        direct = kernels.lazy_output(got_acts, *output_layer(prepared), got_masks,
                                     out_dim=LAZY_OUT, semantics=semantics).numpy()
        for got in (routed, direct):
            assert got.shape == (rows, LAZY_OUT) and got.dtype == np.float32
            np.testing.assert_allclose(got, want, rtol=0, atol=SOFTMAX_ATOL)
        if kind == "inactive":
            expect = 0.0 if semantics == "active_only" else 1.0 / LAZY_OUT
            np.testing.assert_allclose(routed, expect, rtol=0, atol=1e-9)
        if semantics == "active_only":
            assert (routed[masks == 0] == 0).all()

    def test_logits_are_the_masked_logits(self, lazy_nets):
        prepared = lazy_nets[2]
        rng = np.random.default_rng(42)
        acts = torch.as_tensor(rng.integers(-128, 128, (3, 256), dtype=np.int8))
        masks = torch.as_tensor(_lazy_masks("40%", 3, prepared.weights[-1].shape[0], 42))
        args = output_layer(prepared)
        got = kernels.lazy_output(acts, *args, masks, out_dim=LAZY_OUT, logits=True)
        z = kernels.output_logits(acts, *args)[:, :LAZY_OUT]
        assert torch.equal(got, torch.where(masks[:, :LAZY_OUT] != 0, z, 0.0))

    @pytest.mark.parametrize("rows", [1, 64])
    def test_the_cuda_backend_takes_lazy_output(self, lazy_nets, monkeypatch, rows):
        """On the kernels' backend Route.masked_from_acts is one lazy_output
        call at any row count, K5 never; the plain backend's posteriors
        within 3e-5."""
        _, t_q, prepared = lazy_nets
        rng = np.random.default_rng(43 + rows)
        acts = torch.as_tensor(rng.integers(-128, 128, (rows, 256), dtype=np.int8))
        masks = torch.as_tensor(_lazy_masks("40%", rows, LAZY_OUT, 43))
        calls = []
        for name in ("lazy_output", "output_logits"):
            real = getattr(KERNELS, name)
            monkeypatch.setattr(KERNELS, name,
                                lambda *a, _real=real, _name=name, **kw: calls.append(_name)
                                or _real(*a, **kw))
        got = Route(KERNELS, LAZY_OUT).masked_from_acts(prepared, acts, masks)
        assert calls == ["lazy_output"]
        want = Route(PLAIN, LAZY_OUT).masked_from_acts(t_q, acts, masks)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=SOFTMAX_ATOL)


class TestBlockSparse:
    """K6's plain version against the resident block-sparse Pallas kernel."""

    def _band_masks(self, rng, b=128, n=512, out=450, density=0.08):
        """Clustered masks: each 32-frame block activates one narrow id band
        (tests/test_kernels.py's recipe), so many tiles are all zero."""
        masks = np.zeros((b, n), np.uint8)
        for blk in range(b // 32):
            lo = int(rng.integers(0, out - 40))
            band = (rng.random((32, 40)) < density * 10).astype(np.uint8)
            masks[blk * 32:(blk + 1) * 32, lo:lo + 40] = band
        masks[1] = 0
        return masks

    def _run(self, args, masks, out, semantics):
        want = np.asarray(pk.output_layer_posteriors_resident_block_sparse(
            *args, jnp.asarray(masks), out_dim=out, semantics=semantics,
            block_frames=32, block_nodes=128, interpret=True,
        ))
        got = kernels.resident_softmax_block_sparse(
            *_wrapper_args(*args), torch.as_tensor(masks), out_dim=out, semantics=semantics
        ).numpy()
        assert got.shape == want.shape and got.dtype == np.float32
        return got, want

    @pytest.mark.parametrize("semantics", SEMANTICS)
    def test_clustered_band_masks(self, semantics):
        rng = np.random.default_rng(14)
        args = _layer(rng, 128, 128, 512, 450)
        masks = self._band_masks(rng)
        got, want = self._run(args, masks, 450, semantics)
        np.testing.assert_allclose(got, want, rtol=0, atol=SOFTMAX_ATOL)
        dense = kernels.resident_softmax(*_wrapper_args(*args), torch.as_tensor(masks),
                                         out_dim=450, semantics=semantics).numpy()
        np.testing.assert_allclose(got, dense, rtol=0, atol=SOFTMAX_ATOL)
        assert 0 < kernels.block_skip_share(torch.as_tensor(masks)) < 1

    def test_all_active_is_the_dense_softmax(self):
        rng = np.random.default_rng(15)
        args = _layer(rng, 64, 128, 256, 250)
        masks = np.ones((64, 256), np.uint8)
        got, want = self._run(args, masks, 250, "reference")
        np.testing.assert_allclose(got, want, rtol=0, atol=SOFTMAX_ATOL)
        unmasked = kernels.resident_softmax(*_wrapper_args(*args), out_dim=250).numpy()
        np.testing.assert_allclose(got, unmasked, rtol=0, atol=SOFTMAX_ATOL)
        assert kernels.block_skip_share(torch.as_tensor(masks)) == 0.0

    @pytest.mark.parametrize("semantics", SEMANTICS)
    def test_all_inactive(self, semantics):
        rng = np.random.default_rng(16)
        args = _layer(rng, 64, 128, 256, 200)
        masks = np.zeros((64, 256), np.uint8)
        got, want = self._run(args, masks, 200, semantics)
        np.testing.assert_allclose(got, want, rtol=0, atol=SOFTMAX_ATOL)
        if semantics == "reference":
            np.testing.assert_allclose(got, np.full((64, 200), 1 / 200.0), rtol=1e-5)
        else:
            assert (got == 0).all()
        assert kernels.block_skip_share(torch.as_tensor(masks)) == 1.0

    @pytest.mark.parametrize("semantics", SEMANTICS)
    def test_fully_masked_frame_block(self, semantics):
        """K6's 64-frame block with every tile skipped: it runs no product,
        and its rows come out uniform (reference) or zero (active_only)."""
        rng = np.random.default_rng(17)
        args = _layer(rng, 192, 128, 512, 500)
        masks = (rng.random((192, 512)) < 0.3).astype(np.uint8)
        masks[64:128] = 0
        want = np.asarray(pk.output_layer_posteriors_resident_block_sparse(
            *args, jnp.asarray(masks), out_dim=500, semantics=semantics,
            block_frames=64, block_nodes=128, interpret=True,
        ))
        got = kernels.resident_softmax_block_sparse(
            *_wrapper_args(*args), torch.as_tensor(masks), out_dim=500, semantics=semantics
        ).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=SOFTMAX_ATOL)
        np.testing.assert_array_equal(got.argmax(1), want.argmax(1))
        if semantics == "reference":
            np.testing.assert_allclose(got[64:128], 1 / 500.0, rtol=1e-6)
        else:
            assert (got[64:128] == 0).all()
        active = tops.block_activity(torch.as_tensor(masks), 64, 128)
        assert not active[1].any() and active[0].all() and active[2].all()

    @pytest.mark.parametrize("semantics", SEMANTICS)
    def test_out_dim_ends_inside_a_skipped_tile(self, semantics):
        """out_dim = 450 ends inside the last 128-column tile; with that
        tile's mask all zero K6 skips it, and only its 66 valid columns join
        the softmax as the fill logit, never its 62 padding columns."""
        rng = np.random.default_rng(18)
        args = _layer(rng, 128, 256, 512, 450)
        masks = self._band_masks(rng, out=380)
        masks[:, 384:] = 0
        assert not tops.block_activity(torch.as_tensor(masks), 64, 128)[:, 3].any()
        got, want = self._run(args, masks, 450, semantics)
        np.testing.assert_allclose(got, want, rtol=0, atol=SOFTMAX_ATOL)
        np.testing.assert_array_equal(got.argmax(1), want.argmax(1))
        dense = tops.output_posteriors(*(torch.as_tensor(a) for a in args[:3]), float(args[3]),
                                       torch.as_tensor(args[4]), torch.as_tensor(masks),
                                       out_dim=450, semantics=semantics).numpy()
        np.testing.assert_allclose(got, dense, rtol=0, atol=SOFTMAX_ATOL)
        if semantics == "active_only":
            assert (got[:, 384:] == 0).all()
        else:  # one fill posterior per row, exp(0 - m) / s
            assert (got[:, 384:] > 0).all()
            np.testing.assert_array_equal(got[:, 384:], np.repeat(got[:, 384:385], 66, axis=1))

    @pytest.mark.parametrize("kind", ["bands", "random", "empty", "full"])
    def test_block_activity_matches_the_pallas_definition(self, kind):
        """The activity of each (64-frame x 128-column) tile, as K6 finds it
        in its block, against the table the Pallas block-sparse kernel takes
        (`act`, pallas_kernels.py:1063-1064), transposed to [frames, nodes]."""
        rng = np.random.default_rng(19)
        b, n = 256, 1024
        masks = {
            "bands": self._band_masks(rng, b=b, n=n, out=1000),
            "random": (rng.random((b, n)) < 0.002).astype(np.uint8),
            "empty": np.zeros((b, n), np.uint8),
            "full": np.ones((b, n), np.uint8),
        }[kind]
        got = tops.block_activity(torch.as_tensor(masks), 64, 128).numpy()
        ni, nj = b // 64, n // 128
        want = np.asarray((jnp.asarray(masks) != 0).reshape(ni, 64, nj, 128).any(axis=(1, 3)))
        assert got.shape == (ni, nj) and got.dtype == np.bool_
        np.testing.assert_array_equal(got, want)
        assert kernels.block_skip_share(torch.as_tensor(masks)) == pytest.approx(1 - want.mean())


class TestGathered:
    @pytest.mark.parametrize("semantics", SEMANTICS)
    def test_matches_jax_gathered(self, nets, semantics):
        j_q, t_q = nets
        out = j_q.output_dim
        rng = np.random.default_rng(17)
        acts = rng.integers(-128, 128, (32, 256), dtype=np.int8)
        masks = np.zeros((32, out), np.uint8)
        masks[:, rng.choice(out, out // 3, replace=False)] = 1
        masks &= (rng.random((32, out)) < 0.7).astype(np.uint8)
        capacity = min(-(-(out // 2) // 128) * 128, out)
        j_idx, j_count = jlazy.union_active_indices(masks, capacity)
        t_idx, t_count = tlazy.union_active_indices(masks, capacity)
        np.testing.assert_array_equal(t_idx, j_idx)
        assert t_count == j_count == int(masks.any(axis=0).sum())
        want = np.asarray(jlazy.gathered_output_posteriors(
            j_q, acts, masks, jnp.asarray(j_idx), out_dim=out, semantics=semantics))
        ta, tm, ti = torch.as_tensor(acts), torch.as_tensor(masks), torch.as_tensor(t_idx)
        got = tlazy.gathered_output_posteriors(t_q, ta, tm, ti, out_dim=out,
                                               semantics=semantics).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=SOFTMAX_ATOL)
        # the kernels' layout [N, K]: senones are rows
        prepared = KERNELS.prepare(t_q, "cpu")
        rows = tlazy.gathered_output_posteriors(prepared, ta, tm, ti, out_dim=out,
                                                semantics=semantics, backend=KERNELS).numpy()
        np.testing.assert_array_equal(rows, got)

    def test_capacity_overflow_raises(self):
        masks = np.ones((4, 300), np.uint8)
        for union in (jlazy.union_active_indices, tlazy.union_active_indices):
            with pytest.raises(ValueError, match="exceeds capacity"):
                union(masks, 256)


class TestCluster:
    def test_permutation_matches_jax(self):
        rng = np.random.default_rng(18)
        masks = np.zeros((60, 400), np.uint8)
        for t in range(60):
            masks[t, rng.choice(400, 40, replace=False)] = 1
        masks[:, 7] = 0  # never active: goes last
        perm = tcluster.mask_cluster_permutation(masks)
        np.testing.assert_array_equal(perm, jcluster.mask_cluster_permutation(masks))
        np.testing.assert_array_equal(tcluster.inverse_permutation(perm),
                                      jcluster.inverse_permutation(perm))
        assert perm[-1] == 7 or not masks[:, perm[-1]].any()

    def test_permuted_net_relabels_posteriors(self, nets):
        _, t_q = nets
        out = t_q.output_dim
        perm = np.random.default_rng(19).permutation(out).astype(np.int32)
        frames = _frames(19, 100)
        old = fdt.Scorer(t_q, device="cpu").score(frames)
        new = fdt.Scorer(tcluster.permute_output_layer(t_q, perm), device="cpu").score(frames)
        np.testing.assert_allclose(new, old[:, perm], rtol=0, atol=SOFTMAX_ATOL)
        padded = fdt.pad_qnet(t_q)  # padding columns stay in place
        moved = tcluster.permute_output_layer(padded, perm)
        assert moved.padded_output_dim == padded.padded_output_dim
        assert (moved.weights[-1][:, out:] == 0).all()
        with pytest.raises(ValueError, match="permutation"):
            tcluster.permute_output_layer(t_q, perm[:-1])


class TestScorer:
    @pytest.mark.parametrize("semantics", SEMANTICS)
    @pytest.mark.parametrize("lazy_mode", ["dense", "gathered"])
    def test_score_masked_matches_jax(self, nets, semantics, lazy_mode):
        j_q, t_q = nets
        frames = _frames(20, 300)
        masks = _masks(20, 300, j_q.output_dim)
        if lazy_mode == "gathered":
            masks[:, : j_q.output_dim // 2] = 0  # a union the capacity admits
        cfg = dict(lazy_semantics=semantics, lazy_mode=lazy_mode)
        want = fd.Scorer(j_q, fd.EngineConfig(backend="xla", **cfg)).score_masked(frames, masks)
        got = fdt.Scorer(t_q, fdt.EngineConfig(**cfg), device="cpu").score_masked(frames, masks)
        _assert_close_posteriors(got, want)
        if semantics == "active_only":
            assert (got[3] == 0).all() and (got[masks == 0] == 0).all()

    def test_score_masked_matches_jax_pallas(self, nets):
        j_q, t_q = nets
        frames = _frames(21, 100)
        masks = _masks(21, 100, j_q.output_dim)
        want = fd.Scorer(j_q, fd.EngineConfig(backend="pallas", interpret=True)).score_masked(
            frames, masks)
        got = fdt.Scorer(t_q, device="cpu").score_masked(frames, masks)
        _assert_close_posteriors(got, want)

    @pytest.mark.parametrize("semantics", SEMANTICS)
    def test_lazy_context_frame_by_frame(self, nets, semantics):
        j_q, t_q = nets
        frames = _frames(22, 12)
        masks = _masks(22, 12, j_q.output_dim)
        cfg = dict(lazy_semantics=semantics)
        j_ctx = fd.Scorer(j_q, fd.EngineConfig(backend="xla", **cfg)).new_lazy_context(12)
        scorer = fdt.Scorer(t_q, fdt.EngineConfig(**cfg), device="cpu")
        ctx = scorer.new_lazy_context(12)
        j_ctx.calculate_until_output(frames)
        ctx.calculate_until_output(frames)
        got = np.stack([ctx.calculate_for_output_nodes(m) for m in masks])
        want = np.stack([j_ctx.calculate_for_output_nodes(m) for m in masks])
        _assert_close_posteriors(got, want)
        np.testing.assert_allclose(got, scorer.score_masked(frames, masks), rtol=0,
                                   atol=SOFTMAX_ATOL)
        assert ctx.current_vector_index == 12

    def test_unfused_softmax_and_utterances(self, nets):
        j_q, t_q = nets
        utts = {"a": _frames(23, 70), "b": _frames(24, 1), "c": _frames(25, 130)}
        want = fd.Scorer(j_q, fd.EngineConfig(backend="xla")).score_utterances(utts)
        scorer = fdt.Scorer(t_q, fdt.EngineConfig(fused_softmax=False), device="cpu")
        got = scorer.score_utterances(utts)
        assert list(got) == ["a", "b", "c"]
        for key in utts:
            _assert_close_posteriors(got[key], want[key])
        as_list = fdt.Scorer(t_q, device="cpu").score_utterances(list(utts.values()))
        for g, key in zip(as_list, utts):
            np.testing.assert_allclose(g, got[key], rtol=0, atol=SOFTMAX_ATOL)
        assert scorer.score_utterances([]) == [] and scorer.score_utterances({}) == {}

    def test_fast_posteriors(self, nets):
        _, t_q = nets
        frames = _frames(26, 64)
        masks = _masks(26, 64, t_q.output_dim)
        full = fdt.Scorer(t_q, device="cpu")
        fast = fdt.Scorer(t_q, fdt.EngineConfig(fast_posteriors=True), device="cpu")
        for run in (lambda s: s.score(frames), lambda s: s.score_masked(frames, masks)):
            got = run(fast)
            assert got.dtype == np.float32
            np.testing.assert_allclose(got, run(full), rtol=2e-2, atol=1e-3)

    @pytest.mark.parametrize("semantics", SEMANTICS)
    def test_cuda_dispatch_on_cpu_tensors(self, nets, semantics):
        """The CUDA backend's plumbing (padding, kernel layout, mask
        padding, block-sparse dispatch) with CPU tensors, whose wrappers
        take the plain versions."""
        _, t_q = nets
        prepared = KERNELS.prepare(t_q, "cpu")
        frames = torch.as_tensor(_frames(27, 128))
        masks = torch.as_tensor(_masks(27, 128, t_q.output_dim))
        want = score_masked_fn(t_q, frames, masks, backend="torch", semantics=semantics)
        kw = dict(backend="cuda", semantics=semantics, fused_softmax=True,
                  hstack=fdt.build_hidden_stack(prepared), stack_max_frames=8192)
        for block_sparse in (False, True):
            got = score_masked_fn(prepared, frames, masks, block_sparse=block_sparse, **kw)
            assert got.shape == (128, t_q.output_dim)
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=SOFTMAX_ATOL)
        unfused = score_masked_fn(prepared, frames, masks, backend="cuda", semantics=semantics)
        np.testing.assert_allclose(unfused.numpy(), want.numpy(), rtol=0, atol=SOFTMAX_ATOL)
        rows = Route(KERNELS, t_q.output_dim, semantics=semantics).masked_from_acts(
            prepared, fdt.hidden_forward(prepared, frames[:3], "cuda"), masks[:3])
        np.testing.assert_allclose(rows.numpy(), want[:3].numpy(), rtol=0, atol=SOFTMAX_ATOL)


class TestGuards:
    def test_block_sparse_needs_the_cuda_backend(self, nets):
        j_q, t_q = nets
        with pytest.raises(ValueError, match="block_sparse"):
            fd.Scorer(j_q, fd.EngineConfig(backend="xla", lazy_mode="block_sparse"))
        with pytest.raises(ValueError, match="block_sparse"):
            fdt.Scorer(t_q, fdt.EngineConfig(lazy_mode="block_sparse"), device="cpu")

    def test_mask_shape_mismatch_raises(self, nets):
        j_q, t_q = nets
        frames = _frames(28, 10)
        bad = np.ones((10, j_q.output_dim - 1), np.uint8)
        with pytest.raises(ValueError, match="masks must be"):
            fd.Scorer(j_q, fd.EngineConfig(backend="xla")).score_masked(frames, bad)
        with pytest.raises(ValueError, match="masks must be"):
            fdt.Scorer(t_q, device="cpu").score_masked(frames, bad)

    def test_lazy_context_order(self, nets):
        _, t_q = nets
        scorer = fdt.Scorer(t_q, device="cpu")
        ctx = scorer.new_lazy_context(2)
        mask = np.ones(t_q.output_dim, np.uint8)
        with pytest.raises(RuntimeError, match="calculate_until_output"):
            ctx.calculate_for_output_nodes(mask)
        with pytest.raises(ValueError, match="expected 2 frames"):
            ctx.calculate_until_output(_frames(29, 3))
        ctx.calculate_until_output(_frames(29, 2))
        ctx.calculate_for_output_nodes(mask)
        ctx.calculate_for_output_nodes(mask)
        with pytest.raises(IndexError, match="consumed"):
            ctx.calculate_for_output_nodes(mask)

    def test_gathered_capacity_overflow_raises(self, nets):
        _, t_q = nets
        scorer = fdt.Scorer(t_q, fdt.EngineConfig(lazy_mode="gathered"), device="cpu")
        with pytest.raises(ValueError, match="gather capacity"):
            scorer.score_masked(_frames(30, 4), np.ones((4, t_q.output_dim), np.uint8))


class TestDecoder:
    @pytest.fixture(scope="class")
    def setup(self, tmp_path_factory):
        _, j_net = _nets(31, 400)
        j_q = fd.quantize_net(j_net)
        t_q = _carry(j_q, tmp_path_factory.mktemp("dec"))
        lex_rng, frames = np.random.default_rng(3), _frames(31, 60)
        t_lex = fdt.random_lexicon(lex_rng, 30, 400)
        j_lex = j_random_lexicon(np.random.default_rng(3), 30, 400)
        assert t_lex.words == j_lex.words
        t_dec = fdt.BeamDecoder(t_lex, 400, beam_width=32, word_exit_beam=4)
        j_dec = JBeamDecoder(j_lex, 400, beam_width=32, word_exit_beam=4)
        return j_q, t_q, t_dec, j_dec, frames

    def test_lazy_dense_and_rescore_agree(self, setup):
        _, t_q, t_dec, _, frames = setup
        scorer = fdt.Scorer(t_q, device="cpu")
        dense = t_dec.decode_dense(scorer, frames)
        lazy = t_dec.decode_lazy(scorer, frames)
        assert lazy.words == dense.words
        np.testing.assert_array_equal(lazy.masks, dense.masks)
        assert t_dec.decode_rescore(scorer, frames, lazy.masks).words == lazy.words
        assert 0.0 < lazy.avg_density < 0.6 and lazy.avg_churn > 0.0

    @pytest.mark.parametrize("semantics", SEMANTICS)
    def test_words_match_the_jax_decoder(self, setup, semantics):
        j_q, t_q, t_dec, j_dec, frames = setup
        cfg = dict(lazy_semantics=semantics)
        want = j_dec.decode_lazy(fd.Scorer(j_q, fd.EngineConfig(backend="xla", **cfg)), frames)
        got = t_dec.decode_lazy(fdt.Scorer(t_q, fdt.EngineConfig(**cfg), device="cpu"), frames)
        assert got.words == want.words
        np.testing.assert_array_equal(got.masks, want.masks)

    def test_lexicon_validation(self):
        with pytest.raises(ValueError, match="out of senone range"):
            fdt.BeamDecoder(fdt.Lexicon(((1, 2, 999),)), 400)


def test_cli_mask_density_matches_jax_cli(tmp_path):
    t_net, _ = _nets(32, 400)
    fd.write_model(fdt.to_raw(t_net), tmp_path / "model.bin")
    fd.write_features(_frames(32, 300), tmp_path / "feats.bin")
    lazy = ["--mask-density", "0.4", "--seed", "5"]
    assert jcli.main([str(tmp_path / "model.bin"), str(tmp_path / "feats.bin"),
                      str(tmp_path / "jax.bin"), "BIN", "--backend", "xla", *lazy]) == 0
    proc = subprocess.run(
        [sys.executable, "-m", "fastdnn_tpu_torch.cli.score", str(tmp_path / "model.bin"),
         str(tmp_path / "feats.bin"), str(tmp_path / "port.bin"), "BIN", "--device", "cpu", *lazy],
        capture_output=True, text=True, cwd=REPO, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    want = fd.read_features(tmp_path / "jax.bin")
    got = fdt.read_features(tmp_path / "port.bin")
    assert got.shape == want.shape == (300, 400)
    _assert_close_posteriors(got, want)
    masks = tcli.generate_masks(np.random.default_rng(5), 300, 400, 0.4)
    np.testing.assert_array_equal(masks, jcli.generate_masks(np.random.default_rng(5), 300, 400, 0.4))
    assert (got[masks == 1] > 0).all()


def test_cli_block_sparse_on_cpu_fails_cleanly(tmp_path, capsys):
    t_net, _ = _nets(33, 20)
    fdt.write_model(fdt.to_raw(t_net), tmp_path / "model.bin")
    fdt.write_features(_frames(33, 10), tmp_path / "feats.bin")
    assert tcli._cli([str(tmp_path / "model.bin"), str(tmp_path / "feats.bin"), "--device", "cpu",
                      "--mask-density", "0.4", "--lazy-mode", "block_sparse"]) == 2
    assert "block_sparse" in capsys.readouterr().err


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs the same checks on the card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("semantics", SEMANTICS)
def test_lazy_kernels_match_plain_versions_on_card(cuda_device, semantics):
    rng = np.random.default_rng(34)
    x, w, colsum, inv, bias = (torch.as_tensor(a).to(cuda_device) if isinstance(a, np.ndarray)
                               else a for a in _layer(rng, 256, 256, 512, 450))
    w_t = kernels.kernel_layout(w)
    masks = torch.as_tensor(TestBlockSparse()._band_masks(rng, 256, 512, 450)).to(cuda_device)
    assert torch.equal(kernels.output_logits(x, w_t, colsum, float(inv), bias),
                       tops.output_logits(x, w, colsum, float(inv), bias))
    want = tops.output_posteriors(x, w, colsum, float(inv), bias, masks, out_dim=450,
                                  semantics=semantics)
    got = kernels.resident_softmax(x, w_t, colsum, float(inv), bias, masks, out_dim=450,
                                   semantics=semantics)
    assert float((got - want).abs().max()) <= SOFTMAX_ATOL
    got = kernels.resident_softmax_block_sparse(x, w_t, colsum, float(inv), bias, masks,
                                                out_dim=450, semantics=semantics)
    assert float((got - want).abs().max()) <= SOFTMAX_ATOL
    fast = kernels.resident_softmax(x, w_t, colsum, float(inv), bias, masks, out_dim=450,
                                    semantics=semantics, fast=True)
    torch.testing.assert_close(fast.float(), want, rtol=2e-2, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [64, 192, 256])
def test_output_logits_kernel_bitwise_on_card(cuda_device, b):
    """K5 (K2's kernel with an f32 epilogue) bitwise with its plain version:
    one frame block (its columns split over the SMs), three (clusters of 1)
    and four (clusters of 2), on a square and a non-square layer."""
    rng = np.random.default_rng(b)
    for k, n in ((256, 384), (384, 1024)):
        x, w, colsum, inv, bias = (torch.as_tensor(a).to(cuda_device) if isinstance(a, np.ndarray)
                                   else a for a in _layer(rng, b, k, n))
        got = kernels.output_logits(x, kernels.kernel_layout(w), colsum, float(inv), bias)
        assert torch.equal(got, tops.output_logits(x, w, colsum, float(inv), bias)), (b, k, n)


def _on(device, arrays):
    return tuple(torch.as_tensor(a).to(device) if isinstance(a, np.ndarray) else a for a in arrays)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 4])
def test_lazy_output_logits_bitwise_k5_on_card(cuda_device, rows):
    """lazy_output's active logits bitwise K5's (inactive 0): a layer whose
    K is not a multiple of a lane's 512-byte step, a non-square one, and
    the flagship's output layer; masks at the padded width."""
    rng = np.random.default_rng(50 + rows)
    for k, n, out_dim in ((384, 512, 450), (256, 1024, 1000), (2048, 8064, 8000)):
        x, w, colsum, inv, bias = _on(cuda_device, _layer(rng, 64, k, n, out_dim))
        w_t = kernels.kernel_layout(w)
        masks = torch.as_tensor((rng.random((rows, n)) < 0.4).astype(np.uint8)).to(cuda_device)
        got = kernels.lazy_output(x[:rows], w_t, colsum, float(inv), bias, masks,
                                  out_dim=out_dim, logits=True)
        k5 = kernels.output_logits(x, w_t, colsum, float(inv), bias)[:rows, :out_dim]
        assert torch.equal(got, torch.where(masks[:, :out_dim] != 0, k5, 0.0)), (k, n, rows)


@pytest.mark.cuda
@pytest.mark.parametrize("semantics", SEMANTICS)
def test_lazy_output_matches_plain_version_on_card(cuda_device, semantics):
    """lazy_output within 3e-5 of its plain version (the logits, then the
    masked softmax in torch ops) at out_dim 3000, rows 1, 2 and 4, masks all
    inactive, all active and 40% active; the same bits twice.  The layer
    passes check_lazy_output_layer, and a wrong dtype does not."""
    rng = np.random.default_rng(52)
    x, w, colsum, inv, bias = _on(cuda_device, _layer(rng, 4, 256, 3072, LAZY_OUT))
    w_t = kernels.kernel_layout(w)
    kernels.check_lazy_output_layer(w_t, colsum, bias)
    with pytest.raises(ValueError, match="lazy_output"):
        kernels.check_lazy_output_layer(w_t, colsum.float(), bias)
    for rows in (1, 2, 4):
        for kind in ("inactive", "active", "40%"):
            masks = torch.as_tensor(_lazy_masks(kind, rows, LAZY_OUT, rows)).to(cuda_device)
            got = kernels.lazy_output(x[:rows], w_t, colsum, float(inv), bias, masks,
                                      out_dim=LAZY_OUT, semantics=semantics)
            want = tops.masked_softmax(tops.output_logits(x[:rows], w, colsum, float(inv), bias)
                                       [:, :LAZY_OUT], masks != 0, semantics)
            assert float((got - want).abs().max()) <= SOFTMAX_ATOL, (rows, kind)
            assert torch.equal(got, kernels.lazy_output(x[:rows], w_t, colsum, float(inv), bias,
                                                        masks, out_dim=LAZY_OUT,
                                                        semantics=semantics))


@pytest.mark.cuda
def test_lazy_context_decode_launches_lazy_output_on_card(cuda_device):
    """A 60-frame LazyContext decode launches lazy_output once a frame and
    K5 never, within 3e-5 of the plain route."""
    t_net, _ = _nets(53, 1000)
    t_q = fdt.quantize_net(t_net)
    frames = _frames(53, 60)
    masks = _masks(53, 60, 1000)
    rows = []
    for backend in ("cuda", "torch"):
        scorer = fdt.Scorer(t_q, fdt.EngineConfig(backend=backend), device=cuda_device)
        ctx = scorer.new_lazy_context(60)
        ctx.calculate_until_output(frames)
        kernels.reset_launch_counts()
        rows.append(np.stack([ctx.calculate_for_output_nodes(m) for m in masks]))
        counts = kernels.launch_counts()
        if backend == "cuda":
            assert counts["lazy_output"] == 60 and counts["output_logits"] == 0
    np.testing.assert_allclose(rows[0], rows[1], rtol=0, atol=SOFTMAX_ATOL)


# -- a LazyContext frame's host copies: pinned staging on the card, the batch
# entries' pageable path elsewhere (engine.scorer._LazyStaging) --------------


def _lazy_scorer(device, out, **config):
    """A small net (432 -> 2x256 -> out) on `device`, with no JAX."""
    net = fdt.random_net(np.random.default_rng(out), 432, [256, 256], out)
    return fdt.Scorer(fdt.quantize_net(net), fdt.EngineConfig(**config), device=device)


def _decode(scorer, frames, masks, barrier=None):
    """One context's posteriors [n, out], frame by frame; with a barrier,
    in step with the other threads that share it."""
    ctx = scorer.new_lazy_context(len(frames))
    ctx.calculate_until_output(frames)
    rows = []
    for m in masks:
        if barrier is not None:
            barrier.wait(timeout=60)
        rows.append(ctx.calculate_for_output_nodes(m))
    return np.stack(rows)


def _assert_rows_are_the_callers(scorer):
    """A frame's row is unchanged by the next two frames of its context and
    by a frame of a second context, and shares no memory with their rows
    or with the context's staging buffer."""
    frames, masks = _frames(60, 4), _masks(60, 4, scorer.output_dim)
    a, b = scorer.new_lazy_context(4), scorer.new_lazy_context(4)
    a.calculate_until_output(frames)
    b.calculate_until_output(frames[::-1].copy())
    first = a.calculate_for_output_nodes(masks[0])
    kept = first.copy()
    later = [a.calculate_for_output_nodes(masks[1]), a.calculate_for_output_nodes(masks[2]),
             b.calculate_for_output_nodes(masks[1])]
    np.testing.assert_array_equal(first.view(np.uint32), kept.view(np.uint32))
    assert not any(np.array_equal(first, row) for row in later)
    assert not any(np.shares_memory(first, row) for row in later)
    for ctx in (a, b):
        if ctx._staging is not None:
            assert not np.shares_memory(first, ctx._staging.posteriors)


def _assert_wrong_mask_length_raises(scorer):
    """A mask of another length than the senone count raises and leaves
    the context at its frame."""
    ctx = scorer.new_lazy_context(2)
    ctx.calculate_until_output(_frames(61, 2))
    for width in (scorer.output_dim - 1, scorer.output_dim + 128):
        with pytest.raises(ValueError):
            ctx.calculate_for_output_nodes(np.ones(width, np.uint8))
    assert ctx.current_vector_index == 0
    assert ctx.calculate_for_output_nodes(np.ones(scorer.output_dim, np.uint8)).shape == (
        scorer.output_dim,)


class TestLazyStaging:
    def test_cpu_frames_count_as_pageable(self):
        """A CPU context takes the batch entries' pageable path: it never
        makes pinned buffers."""
        scorer = _lazy_scorer("cpu", 450)
        frames, masks = _frames(62, 5), _masks(62, 5, 450)
        ctx = scorer.new_lazy_context(5)
        ctx.calculate_until_output(frames)
        for m in masks:
            assert ctx.calculate_for_output_nodes(m).shape == (450,)
            assert not ctx._staged and ctx._staging is None
        assert ctx.current_vector_index == 5

    def test_rows_are_the_callers(self):
        _assert_rows_are_the_callers(_lazy_scorer("cpu", 450))

    def test_wrong_mask_length_raises(self):
        _assert_wrong_mask_length_raises(_lazy_scorer("cpu", 450))


@pytest.mark.cuda
@pytest.mark.parametrize("out", [8000, 17552])
@pytest.mark.parametrize("semantics", SEMANTICS)
def test_staged_frames_bitwise_the_pageable_path_on_card(cuda_device, semantics, out):
    """Each staged frame's posteriors bitwise those of the same frame built
    through the batch entries' pageable stages (Scorer._masks, the output
    layer, Scorer._finish), a frame with no active senone among them; every
    frame through the context's pinned buffers."""
    scorer = _lazy_scorer(cuda_device, out, lazy_semantics=semantics)
    n = 6
    frames, masks = _frames(63, n), _masks(63, n, out)
    ctx = scorer.new_lazy_context(n)
    ctx.calculate_until_output(frames)
    for t in range(n):
        got = ctx.calculate_for_output_nodes(masks[t])
        assert ctx._staged and ctx._staging is not None
        _, mask_d = scorer._masks(masks[t].reshape(1, -1), 1)
        want = scorer._finish(scorer._masked_from_acts(ctx._acts[t:t + 1], mask_d), 1)[0]
        assert got.shape == (out,) and got.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert ctx._staging is not None and ctx._staging.mask_host.is_pinned()
    assert ctx._staging.posteriors_host.is_pinned()


@pytest.mark.cuda
def test_staged_rows_are_the_callers_on_card(cuda_device):
    scorer = _lazy_scorer(cuda_device, 8000)
    _assert_rows_are_the_callers(scorer)
    _assert_wrong_mask_length_raises(scorer)


@pytest.mark.cuda
def test_staged_gathered_frames_bitwise_on_card(cuda_device):
    """lazy_mode="gathered" reads the union from the pinned mask row: each
    frame bitwise the same frame built through the pageable stages."""
    scorer = _lazy_scorer(cuda_device, 8000, lazy_mode="gathered", lazy_capacity=1.0)
    n = 5
    frames, masks = _frames(64, n), _masks(64, n, 8000)
    ctx = scorer.new_lazy_context(n)
    ctx.calculate_until_output(frames)
    for t in range(n):
        got = ctx.calculate_for_output_nodes(masks[t])
        mask_p, mask_d = scorer._masks(masks[t].reshape(1, -1), 1)
        idx, _ = tlazy.union_active_indices(mask_p, scorer._gather_capacity)
        out = scorer._gathered(ctx._acts[t:t + 1], mask_d, scorer._to_device(idx))
        np.testing.assert_array_equal(got.view(np.uint32),
                                      scorer._finish(out, 1)[0].view(np.uint32))


@pytest.mark.cuda
def test_staged_contexts_on_two_threads_on_card(cuda_device):
    """Two contexts decoding in step on two threads, under fast thread
    switching, give bitwise the rows each gives alone."""
    scorer = _lazy_scorer(cuda_device, 17552)
    inputs = [(_frames(65 + k, 40), _masks(65 + k, 40, 17552)) for k in range(2)]
    want = [_decode(scorer, *x) for x in inputs]
    barrier = threading.Barrier(2)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            futures = [pool.submit(_decode, scorer, *x, barrier) for x in inputs]
            got = [f.result(timeout=120) for f in futures]
    finally:
        sys.setswitchinterval(old)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.view(np.uint32), w.view(np.uint32))

"""The port's tensor-parallel scorer against the JAX package, on CPU.

One module-scoped fixture per mesh shape (data x model = 1x2, 2x2, 1x4)
spawns the ranks once (torch.multiprocessing, gloo through a rendezvous
file, tests/torch_mesh_worker.py), each rank running every case; the tests
hold what the ranks gave against JAX's `Scorer(mesh=make_mesh(data,
model))` on the virtual CPU devices (tests/conftest.py), xla and Pallas in
interpret mode with the fused softmax, and against the single-device JAX
`Scorer`.  The ranks import no JAX.  Net: 432 -> 2x128 -> 300, so the
output pads to 512 columns and the last model shard of the 1x4 mesh holds
only padding (valid count 0).  Bound: posteriors within 1e-4 with argmax
agreement >= 0.999, as test_scorer_from_frames_matches_jax.
"""

import numpy as np
import pytest
import torch

import fastdnn_tpu as fd
import fastdnn_tpu_torch as fdt
import torch_mesh_worker
from fastdnn_tpu.parallel import mesh as jmesh
from fastdnn_tpu.parallel.sharded import score_shard_map
from fastdnn_tpu.quant.quantize import pad_qnet_for_tpu

POSTERIOR_ATOL = 1e-4
ARGMAX_AGREEMENT = 0.999
RANK_TIMEOUT_S = 120
OUT = 300
SEMANTICS = ["reference", "active_only"]


def _assert_close(got, want):
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= POSTERIOR_ATOL
    assert (got.argmax(1) == want.argmax(1)).mean() >= ARGMAX_AGREEMENT


@pytest.fixture(scope="module")
def j_q():
    t_net = fdt.random_net(np.random.default_rng(9), 432, [128, 128], OUT)
    return fd.quantize_net(fd.from_raw(fdt.to_raw(t_net)))


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(10)
    masks = (rng.random((100, OUT)) < 0.4).astype(np.uint8)
    masks[7] = 0  # a frame with no active senone
    bands = np.zeros((128, OUT), np.uint8)  # decoder-like clustered masks
    bands[:64, 20:90] = rng.random((64, 70)) < 0.5
    bands[64:, 180:260] = rng.random((64, 80)) < 0.5
    bands[7] = 0
    return {
        "frames": rng.standard_normal((100, 432), dtype=np.float32),
        "masks": masks,
        "frames128": rng.standard_normal((128, 432), dtype=np.float32),
        "bands": bands,
    }


@pytest.fixture(scope="module", params=[(1, 2), (2, 2), (1, 4)], ids=["1x2", "2x2", "1x4"])
def ranks(request, j_q, inputs, tmp_path_factory):
    """Spawn data x model ranks once; -> (data, model, [each rank's results])."""
    data, model = request.param
    world = data * model
    work = tmp_path_factory.mktemp(f"mesh{data}x{model}")
    fd.save_qnet(j_q, work / "q.npz")
    np.savez(work / "inputs.npz", **inputs)
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=torch_mesh_worker.run, args=(r, world, data, model, str(work)))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(RANK_TIMEOUT_S)
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errors = {r: (work / f"rank{r}.err").read_text() for r in range(world)
              if (work / f"rank{r}.err").exists()}
    assert not hung, f"ranks {hung} did not finish within {RANK_TIMEOUT_S} s; errors: {errors}"
    assert all(p.exitcode == 0 for p in procs) and not errors, errors
    results = []
    for r in range(world):
        with np.load(work / f"rank{r}.npz") as z:
            results.append({k: z[k] for k in z.files})
    return data, model, results


def _jax_scorer(j_q, data=None, model=None, **cfg):
    mesh = None
    if data is not None:
        import jax

        mesh = jmesh.make_mesh(data=data, model=model, devices=jax.devices()[: data * model])
    return fd.Scorer(j_q, fd.EngineConfig(**cfg), mesh=mesh)


def test_every_rank_returns_the_same_posteriors(ranks):
    _, _, results = ranks
    for other in results[1:]:
        for key, value in results[0].items():
            np.testing.assert_array_equal(other[key], value, err_msg=key)


def test_score_matches_jax_mesh_and_single_device(ranks, j_q, inputs):
    data, model, results = ranks
    frames = inputs["frames"]
    got = results[0]["score"]
    _assert_close(got, _jax_scorer(j_q, backend="xla").score(frames))
    _assert_close(got, _jax_scorer(j_q, data, model, backend="xla").score(frames))
    np.testing.assert_allclose(got.sum(axis=1), 1.0, rtol=0, atol=1e-5)


def test_score_matches_jax_fused_pallas_mesh(ranks, j_q, inputs):
    """The fused softmax (the stats kernel's plain version per rank, two
    all-reduces) against JAX's per-shard flash-stats kernel in interpret
    mode with its pmax/psum combine."""
    data, model, results = ranks
    want = _jax_scorer(j_q, data, model, backend="pallas", interpret=True,
                       fused_softmax=True).score(inputs["frames"])
    _assert_close(results[0]["score"], want)


@pytest.mark.parametrize("semantics", SEMANTICS)
def test_score_masked_matches_jax(ranks, j_q, inputs, semantics):
    data, model, results = ranks
    frames, masks = inputs["frames"], inputs["masks"]
    got = results[0][f"masked_{semantics}"]
    _assert_close(got, _jax_scorer(j_q, backend="xla", lazy_semantics=semantics)
                  .score_masked(frames, masks))
    _assert_close(got, _jax_scorer(j_q, data, model, backend="xla", lazy_semantics=semantics)
                  .score_masked(frames, masks))
    if semantics == "active_only":
        np.testing.assert_array_equal(got[7], 0.0)  # the fully masked frame
        assert (got[masks == 0] == 0).all()


@pytest.mark.parametrize("semantics", SEMANTICS)
def test_unfused_logits_and_collective_softmax(ranks, j_q, inputs, semantics):
    """fused_softmax=False: the logits kernel's plain version per rank and
    the collective softmax, against JAX's unfused Pallas mesh path."""
    data, model, results = ranks
    frames, masks = inputs["frames"], inputs["masks"]
    want = _jax_scorer(j_q, data, model, backend="pallas", interpret=True, fused_softmax=False,
                       lazy_semantics=semantics).score_masked(frames, masks)
    _assert_close(results[0][f"unfused_masked_{semantics}"], want)
    if semantics == "reference":
        _assert_close(results[0]["unfused_score"], _jax_scorer(j_q, backend="xla").score(frames))


@pytest.mark.parametrize("semantics", SEMANTICS)
def test_block_sparse_matches_jax(ranks, j_q, inputs, semantics):
    """lazy_mode="block_sparse": each rank's skipping stats kernel (plain
    version) with capped fills, against JAX's block-sparse mesh scorer and
    the single-device dense masked scorer, on band masks with a dead frame."""
    data, model, results = ranks
    frames, bands = inputs["frames128"], inputs["bands"]
    got = results[0][f"block_sparse_{semantics}"]
    _assert_close(got, _jax_scorer(j_q, backend="xla", lazy_semantics=semantics)
                  .score_masked(frames, bands))
    want = _jax_scorer(j_q, data, model, backend="pallas", interpret=True, fused_softmax=True,
                       lazy_semantics=semantics, lazy_mode="block_sparse")
    _assert_close(got, want.score_masked(frames, bands))


def test_score_shard_map_and_padding(ranks, j_q, inputs):
    """score_shard_map keeps the padded width; its padding columns (the
    whole last shard on the 1x4 mesh) are exactly 0 and stay out of the
    softmax."""
    data, model, results = ranks
    import jax

    frames = inputs["frames128"][:64]
    masks = inputs["masks"][:64]
    jm = jmesh.make_mesh(data=data, model=model, devices=jax.devices()[: data * model])
    padded = pad_qnet_for_tpu(j_q, out_lanes=128 * model)

    fp = np.zeros((64, padded.input_dim), np.float32)
    fp[:, :432] = frames
    for key, m in (("shard_map", None), ("shard_map_masked", masks)):
        got = results[0][key]
        assert got.shape == (64, 512)
        np.testing.assert_array_equal(got[:, OUT:], 0.0)
        mp = None
        if m is not None:
            mp = np.zeros((64, padded.padded_output_dim), np.uint8)
            mp[:, :OUT] = m
        want = np.asarray(score_shard_map(padded, fp, jm, masks=mp))
        _assert_close(got[:, :OUT], want[:, :OUT])
    _assert_close(results[0]["shard_map"][:, :OUT], _jax_scorer(j_q, backend="xla").score(frames))


def test_lazy_context_and_utterances_under_mesh(ranks, j_q, inputs):
    _, _, results = ranks
    frames, masks = inputs["frames"], inputs["masks"]
    single = _jax_scorer(j_q, backend="xla")
    _assert_close(results[0]["lazy_rows"], single.score_masked(frames[:3], masks[:3]))
    _assert_close(results[0]["utterances"], single.score(frames[:24]))


def test_score_device_returns_the_rank_block(ranks):
    data, model, results = ranks
    assert tuple(results[0]["device_block_shape"]) == (128 // data, 512 // model)


def test_refusals(ranks):
    """gathered mode under a mesh; block_sparse without the CUDA backend and
    the fused softmax (Scorer and make_mesh_programs)."""
    _, _, results = ranks
    assert results[0]["refuses"].tolist() == [True, True, True, True]


def test_make_mesh_needs_cuda_unless_asked_for_cpu(tmp_path, monkeypatch):
    """Without a CUDA device, make_mesh() raises rather than label the mesh
    "cpu"; device_type="cpu" builds it.  One gloo rank in this process,
    its group destroyed after."""
    import torch.distributed as dist

    from fastdnn_tpu_torch.parallel import mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rendezvous'}",
                            world_size=1, rank=0)
    try:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            mesh.make_mesh()
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            mesh.make_mesh(1, 1, device_type="cuda")
        assert mesh.mesh_shape(mesh.make_mesh(device_type="cpu")) == (1, 1)
    finally:
        dist.destroy_process_group()
    assert not dist.is_initialized()

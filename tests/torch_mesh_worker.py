"""One rank of the port's tensor-parallel scorer, for tests/test_torch_parallel.py.

Started once per rank with torch.multiprocessing (spawn) by the test's
fixtures: the ranks join a gloo process group through a rendezvous file in
`workdir`, build a ("data", "model") mesh, load the net and the inputs the
test wrote there (`q.npz`, `inputs.npz`), run every case on the CPU and
write their posteriors to `rank<r>.npz`; a failure is written to
`rank<r>.err`.  It imports no JAX: the test compares the results with the
JAX package in its own process.
"""

from __future__ import annotations

import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

SEMANTICS = ("reference", "active_only")


def _block_sparse(q, mesh, frames, masks, semantics):
    """The masked mesh program with lazy_mode="block_sparse" on the CUDA
    backend's route, driven with CPU tensors: every kernel wrapper of the
    route (the skipping stats kernel among them) runs its plain version."""
    from fastdnn_tpu_torch.engine.backend import KERNELS
    from fastdnn_tpu_torch.engine.scorer import Route
    from fastdnn_tpu_torch.parallel import mesh as pmesh
    from fastdnn_tpu_torch.parallel.sharded import make_mesh_programs

    model = pmesh.mesh_shape(mesh)[1]
    net = KERNELS.prepare(q, "cpu", mesh=mesh)
    _, score_masked, _, _ = make_mesh_programs(mesh, Route(
        KERNELS, q.output_dim, fused_softmax=True, semantics=semantics, block_sparse=True))
    masks_p = np.zeros((masks.shape[0], net.padded_output_dim * model), np.uint8)
    masks_p[:, : q.output_dim] = masks
    local_masks = pmesh.local_cols(pmesh.local_rows(torch.from_numpy(masks_p), mesh), mesh)
    p = score_masked(net, pmesh.local_rows(torch.from_numpy(frames), mesh), local_masks)
    return pmesh.gather_blocks(p, mesh)[:, : q.output_dim].numpy()


def _refuses(fn) -> bool:
    try:
        fn()
    except ValueError:
        return True
    return False


def _cases(q, mesh, inputs) -> dict:
    from fastdnn_tpu_torch import EngineConfig, Scorer
    from fastdnn_tpu_torch.engine.backend import KERNELS, PLAIN
    from fastdnn_tpu_torch.engine.scorer import Route
    from fastdnn_tpu_torch.parallel.sharded import make_mesh_programs, score_shard_map
    from fastdnn_tpu_torch.quant.quantize import pad_qnet

    data, model = mesh.size(0), mesh.size(1)
    frames, masks = inputs["frames"], inputs["masks"]
    out = {}
    for semantics in SEMANTICS:
        scorer = Scorer(q, EngineConfig(lazy_semantics=semantics), device="cpu", mesh=mesh)
        unfused = Scorer(q, EngineConfig(lazy_semantics=semantics, fused_softmax=False),
                         device="cpu", mesh=mesh)
        out[f"masked_{semantics}"] = scorer.score_masked(frames, masks)
        out[f"unfused_masked_{semantics}"] = unfused.score_masked(frames, masks)
        out[f"block_sparse_{semantics}"] = _block_sparse(
            q, mesh, inputs["frames128"], inputs["bands"], semantics)
    out["score"] = scorer.score(frames)
    out["unfused_score"] = unfused.score(frames)
    block = scorer.score_device(torch.from_numpy(inputs["frames128"]))
    out["device_block_shape"] = np.array(block.shape)

    reference = Scorer(q, EngineConfig(), device="cpu", mesh=mesh)
    ctx = reference.new_lazy_context(3)
    ctx.calculate_until_output(frames[:3])
    out["lazy_rows"] = np.stack([ctx.calculate_for_output_nodes(masks[i]) for i in range(3)])
    utts = reference.score_utterances([frames[:5], frames[5:13], frames[13:24]])
    out["utterances"] = np.concatenate(utts)

    padded = pad_qnet(q, lanes=1, out_lanes=128 * model)
    f64 = torch.from_numpy(inputs["frames128"][:64])
    m64 = np.zeros((64, padded.padded_output_dim), np.uint8)
    m64[:, : q.output_dim] = masks[:64]
    out["shard_map"] = score_shard_map(padded, f64, mesh).numpy()
    out["shard_map_masked"] = score_shard_map(padded, f64, mesh, masks=torch.from_numpy(m64)).numpy()

    out["refuses"] = np.array([
        _refuses(lambda: Scorer(q, EngineConfig(lazy_mode="gathered"), device="cpu", mesh=mesh)),
        _refuses(lambda: Scorer(q, EngineConfig(lazy_mode="block_sparse"), device="cpu",
                                mesh=mesh)),
        _refuses(lambda: make_mesh_programs(mesh, Route(KERNELS, q.output_dim,
                                                        block_sparse=True))),
        _refuses(lambda: make_mesh_programs(mesh, Route(PLAIN, q.output_dim, fused_softmax=True,
                                                        block_sparse=True))),
    ])
    out["mesh"] = np.array([data, model])
    return out


def run(rank: int, world: int, data: int, model: int, workdir: str) -> None:
    """Rank `rank` of `world`: join, build the mesh, run the cases, write
    rank<r>.npz (or rank<r>.err), leave the group."""
    work = Path(workdir)
    try:
        from fastdnn_tpu_torch.parallel.mesh import init_multihost, make_mesh
        from fastdnn_tpu_torch.quant.serialize import load_qnet

        init_multihost(f"file://{work / 'rendezvous'}", world_size=world, rank=rank,
                       backend="gloo")
        mesh = make_mesh(data, model, device_type="cpu")
        with np.load(work / "inputs.npz") as z:
            inputs = {k: z[k] for k in z.files}
        with torch.inference_mode():
            out = _cases(load_qnet(work / "q.npz"), mesh, inputs)
        np.savez(work / f"rank{rank}.npz", **out)
        dist.destroy_process_group()
    except BaseException:
        (work / f"rank{rank}.err").write_text(traceback.format_exc())
        raise

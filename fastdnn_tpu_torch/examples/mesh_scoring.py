"""Tensor-parallel scoring on the PyTorch/CUDA port: the same API, one extra
argument, as the JAX package's examples/mesh_scoring.py shows it.

    python -m fastdnn_tpu_torch.examples.mesh_scoring [--device cuda|cpu]
        [--features F] [--model MODEL.bin] [--tp 2] [--ranks N]

The demo starts --ranks processes (default: --tp) that join one gloo
process group on localhost, build a ("data", "model") mesh with --tp model
ranks, and score the same frames with `Scorer(mesh=...)`: frames split
over the data ranks, the senone axis over the model ranks.  With --device
cuda every rank scores on cuda:0, the ranks sharing the one card (gloo
carries their collectives); with --device cpu they are CPU ranks.  Rank 0
holds the posteriors, full and masked, against a single-device Scorer's
(asserted within 1e-4, the port's mesh bound).
"""

from __future__ import annotations

import argparse
import tempfile
import traceback

import numpy as np

from . import _common

#: mesh posteriors against one device (tests/test_torch_parallel.py)
MESH_ATOL = 1e-4
RANK_TIMEOUT_S = 300


def _rank(rank: int, port: int, world: int, args: dict, frames_path: str, results) -> None:
    """One rank: join, build the mesh Scorer, score; rank 0 prints and
    checks.  Each rank puts its report (or its traceback) on `results`."""
    try:
        _score_rank(rank, port, world, args, frames_path)
    except BaseException:
        results.put({"rank": rank, "error": traceback.format_exc()})
        raise
    results.put({"rank": rank})


def _score_rank(rank: int, port: int, world: int, args: dict, frames_path: str) -> None:
    import torch
    import torch.distributed as dist

    import fastdnn_tpu_torch as fdt
    from fastdnn_tpu_torch.parallel.mesh import init_multihost, make_mesh, mesh_shape

    device = torch.device("cuda", 0) if args["device"] == "cuda" else torch.device("cpu")
    if device.type == "cuda":
        torch.cuda.set_device(device)  # every rank on the one card
    init_multihost(f"tcp://localhost:{port}", world_size=world, rank=rank, backend="gloo")
    try:
        if args["model"]:
            net = fdt.load_model(args["model"])
        else:
            net = fdt.align(fdt.random_net(np.random.default_rng(0), _common.FEATURE_DIM,
                                           [512] * 3, 2000), 4, 16)
        qnet = fdt.quantize_net(net, cutoff=3.0)
        frames = fdt.read_features(frames_path)
        mesh = make_mesh(model=args["tp"], device_type=device.type)
        sc = fdt.Scorer(qnet, mesh=mesh, device=device)
        post = sc.score(frames)
        masks = (np.random.default_rng(1).random((len(frames), sc.output_dim)) < 0.4)
        masks = masks.astype(np.uint8)
        post_m = sc.score_masked(frames, masks)
        if rank == 0:
            single = fdt.Scorer(qnet, device=device)
            d = float(np.abs(post - single.score(frames)).max())
            d_m = float(np.abs(post_m - single.score_masked(frames, masks)).max())
            data, model = mesh_shape(mesh)
            print(f"ranks: {world} (gloo, {device}), mesh: data={data} x model={model}")
            print(f"posteriors {post.shape}, rowsum [{post.sum(1).min():.5f}, "
                  f"{post.sum(1).max():.5f}]")
            print(f"max |mesh - single-device| = {d:.2e}")
            print(f"masked   max |mesh - single-device| = {d_m:.2e}", flush=True)
            _common.check(d <= MESH_ATOL and d_m <= MESH_ATOL,
                          f"mesh {d}, masked {d_m} from one device > {MESH_ATOL}")
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m fastdnn_tpu_torch.examples.mesh_scoring")
    _common.add_flags(p)
    p.add_argument("--model", default=None,
                   help="reference-format binary model (default: random 3x512/2000)")
    p.add_argument("--tp", type=int, default=2, help="tensor-parallel ranks (senone axis)")
    p.add_argument("--ranks", type=int, default=None, help="processes (default: --tp)")
    args = p.parse_args(argv)
    _common.device_of(args)
    world = args.ranks or args.tp
    if world % args.tp:
        raise SystemExit(f"{world} ranks not divisible by tp={args.tp}")

    from ..parallel.spawn import run_ranks

    with tempfile.TemporaryDirectory(prefix="fastdnn_torch_demo_") as td:
        frames_path = str(_common.frames_file(args.features, td))
        try:
            run_ranks(_rank, world, (world, vars(args), frames_path), timeout=RANK_TIMEOUT_S,
                      what=f"{world} mesh ranks")
        except (RuntimeError, TimeoutError) as e:
            print(f"a rank failed: {e}")
            return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

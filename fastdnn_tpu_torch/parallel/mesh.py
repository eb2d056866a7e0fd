"""Process mesh and per-rank layout on torch.distributed: the counterpart of
fastdnn_tpu/parallel/mesh.py.

The JAX package's mesh is one program over many devices.  Here the model
is SPMD, as JAX's multi-controller runtime is across hosts: one process per
rank, every rank running the same calls with the same host inputs.  The
mesh has two axes:

  * "data":  frame batches are split by rows over the data ranks;
  * "model": the output layer (8000+ senones) is split by columns over the
    model ranks, its softmax made exact by two all-reduces of per-row stats
    (parallel/sharded.py).

Hidden layers are replicated on every rank (40 MB of int8 for the 7x2048
net), so the only per-batch collectives are the output layer's.

Start the ranks with `torchrun` (which sets the rendezvous environment) or
spawn them and give `init_multihost` an address, a world size and a rank.
The backend is the caller's: "nccl" for one card per rank, "gloo" for the
CPU or for several ranks sharing one card (NCCL refuses two ranks on one
device).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..quant.quantize import QuantizedNet

DATA_AXIS = "data"
MODEL_AXIS = "model"


def init_multihost(init_method: Optional[str] = None, *, world_size: Optional[int] = None,
                   rank: Optional[int] = None, backend: str = "gloo", **kwargs) -> None:
    """Join the process group: `torch.distributed.init_process_group` with
    an explicit rendezvous (e.g. "tcp://localhost:29511" or "file:///path").
    With no arguments at all it is a no-op, as for one process; torchrun
    users pass init_method="env://"."""
    if init_method is None and world_size is None and rank is None and not kwargs:
        return
    # torch reads -1 as "from the rendezvous" (torchrun's environment)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=-1 if world_size is None else world_size,
                            rank=-1 if rank is None else rank, **kwargs)


def make_mesh(data: Optional[int] = None, model: int = 1, *,
              device_type: str = "cuda") -> DeviceMesh:
    """A ("data", "model") mesh over every rank of the process group.

    With `data=None` the data axis takes all ranks the model axis leaves.
    `device_type` is "cuda" unless the caller asks for "cpu"; without a
    CUDA device a "cuda" mesh raises rather than turn into a CPU one.  It
    is the mesh's label only: each rank scores on the device its Scorer is
    given."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: join the process group first (init_multihost)")
    world = dist.get_world_size()
    if data is None:
        if world % model:
            raise ValueError(f"{world} ranks not divisible by model={model}")
        data = world // model
    if data * model != world:
        raise ValueError(f"mesh {data}x{model} != {world} ranks")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "make_mesh(device_type='cuda'): CUDA is not available; pass device_type='cpu' "
            "for a mesh of CPU ranks"
        )
    return init_device_mesh(device_type, (data, model), mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def mesh_shape(mesh: DeviceMesh) -> tuple[int, int]:
    """(data, model) sizes."""
    return mesh.size(0), mesh.size(1)


def mesh_coords(mesh: DeviceMesh) -> tuple[int, int]:
    """This rank's (data, model) coordinates."""
    return mesh.get_local_rank(DATA_AXIS), mesh.get_local_rank(MODEL_AXIS)


def shard_qnet(qnet: QuantizedNet, mesh: DeviceMesh) -> QuantizedNet:
    """This rank's net, in the JAX layout ([K, N] weights): the trunk as it
    is (replicated), the output layer's columns [r n_local, (r + 1) n_local)
    for model rank r.  The output width must divide by the model axis (pad
    with quant.quantize.pad_qnet(out_lanes=128 * model) first).  With
    model = 1 the net is returned unchanged; otherwise the local net carries
    no true senone count (its width is n_local)."""
    _, model = mesh_shape(mesh)
    if model == 1:
        return qnet
    n = qnet.weights[-1].shape[1]
    if n % model:
        raise ValueError(f"output width {n} does not split over model={model}; pad the net first")
    n_local = n // model
    lo = mesh_coords(mesh)[1] * n_local
    hi = lo + n_local
    return dataclasses.replace(
        qnet,
        weights=(*qnet.weights[:-1], qnet.weights[-1][:, lo:hi].contiguous()),
        colsum128=(*qnet.colsum128[:-1], qnet.colsum128[-1][lo:hi].contiguous()),
        biases=(*qnet.biases[:-1], qnet.biases[-1][lo:hi].contiguous()),
        true_output_dim=None,
    )


def local_rows(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """This data rank's rows of a batch [B, ...] (B divisible by the data
    axis), contiguous."""
    data, _ = mesh_shape(mesh)
    if x.shape[0] % data:
        raise ValueError(f"{x.shape[0]} rows do not split over data={data}")
    rows = x.shape[0] // data
    return x[mesh_coords(mesh)[0] * rows:][:rows].contiguous()


def local_cols(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """This model rank's columns of [B, N] (N divisible by the model axis),
    contiguous: the output-layer slice of a mask."""
    _, model = mesh_shape(mesh)
    cols = x.shape[1] // model
    return x[:, mesh_coords(mesh)[1] * cols:][:, :cols].contiguous()


def _all_gather(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Concatenate every rank's `t` along `dim`, in group-rank order.  A
    gloo group gathers host tensors (the result lands on the host); an NCCL
    group gathers on the device."""
    size = dist.get_world_size(group)
    if size == 1:
        return t
    src = t.contiguous() if dist.get_backend(group) == "nccl" else t.cpu().contiguous()
    parts = [torch.empty_like(src) for _ in range(size)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim)


def gather_blocks(local: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """Every rank's [B / data, width / model] block -> the full [B, width]
    on every rank: columns over the model axis, then rows over the data
    axis."""
    cols = _all_gather(local, mesh.get_group(MODEL_AXIS), dim=1)
    return _all_gather(cols, mesh.get_group(DATA_AXIS), dim=0)


def gather_rows(local: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """Every data rank's rows -> the full batch on every rank (the model
    ranks of one data row hold the same rows)."""
    return _all_gather(local, mesh.get_group(DATA_AXIS), dim=0)

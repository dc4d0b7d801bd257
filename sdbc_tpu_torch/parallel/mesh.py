"""The ``(data, model)`` mesh over the ranks of ``torch.distributed``
(counterpart of ``sdbc_tpu/parallel/mesh.py``).

The JAX package runs one process over many devices and lays a
``jax.sharding.Mesh`` over them; the port runs one process per card, so
the mesh is a ``DeviceMesh`` named ``("data", "model")`` over the world's
ranks in rank order (rank = data coordinate × model + model coordinate).
That order is slice-major: a multi-slice job keeps each slice's ranks in
one contiguous block of the data axis, so ``num_slices`` keeps the JAX
package's validation.

There is no global array here.  A rank holds only its rows of a batch
(``host_local_batch_indices``), on its own device; the collectives that
XLA inserts under a JAX mesh are explicit calls of ``parallel.comm``.
"""
from __future__ import annotations

import dataclasses
import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    data: int = -1   # -1: all remaining ranks
    model: int = 1   # tensor-parallel axis
    # slices joined by a slower network: the data axis must split evenly
    # over them (the outer part of the gradient reduction crosses it)
    num_slices: int = 1

    def resolve(self, n_devices: int) -> tuple:
        model = self.model
        data = self.data if self.data > 0 else n_devices // model
        if data * model != n_devices:
            raise ValueError(f"mesh {data}x{model} != {n_devices} devices")
        if data % self.num_slices:
            raise ValueError(f"data axis {data} not divisible by "
                             f"{self.num_slices} slices")
        return data, model


def make_mesh(cfg: MeshConfig = MeshConfig(), device=None):
    """A ``DeviceMesh`` named ("data", "model") over every rank of the
    initialised process group, in rank order.  ``device``: the rank's
    device (default ``cuda`` when the card is there, else ``cpu``); the
    mesh's device type follows it."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed initialised "
                           "(cli.common.maybe_init_distributed, or "
                           "init_process_group with its rank and world "
                           "size)")
    data, model = cfg.resolve(dist.get_world_size())
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    if dev.type == "cuda":
        # the rank's card before the mesh's groups come up
        torch.cuda.set_device(dev if dev.index is not None
                              else torch.cuda.current_device())
    ranks = torch.arange(data * model).reshape(data, model)
    return DeviceMesh(dev.type, ranks, mesh_dim_names=("data", "model"))


def mesh_shape(mesh) -> dict:
    """{"data": d, "model": m}: the JAX ``mesh.shape``."""
    return {"data": mesh.size(0), "model": mesh.size(1)}


def mesh_device(mesh) -> torch.device:
    """The rank's device on ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _local_data_coords(process_map: np.ndarray, process_index: int):
    """Data-axis coordinates owned by a process (the pure core).

    process_map: (data, model) int array of each position's process.  A
    data coordinate is local iff ANY of its positions belongs to the
    process; the coordinates need not be contiguous, and the exact sorted
    list is returned, not a min..max span."""
    return sorted({int(c) for c in
                   np.argwhere(process_map == process_index)[:, 0]})


def host_local_data_coords(mesh):
    """This rank's data coordinates: one per rank here (one process per
    card)."""
    from torch.distributed import get_rank

    pmap = np.asarray(mesh.mesh.cpu().numpy())
    return _local_data_coords(pmap.reshape(pmap.shape[0], -1), get_rank())


def host_local_batch_indices(global_batch: int, mesh) -> np.ndarray:
    """Row indices of the global batch this rank loads: each data
    coordinate's contiguous block of ``global_batch / data`` rows."""
    n_data = mesh_shape(mesh)["data"]
    if global_batch % n_data:
        # a silent floor here would drop rows from every assembled batch
        raise ValueError(
            f"global batch {global_batch} must divide evenly over the "
            f"mesh's data axis ({n_data} shards)")
    per_shard = global_batch // n_data
    coords = host_local_data_coords(mesh)
    if not coords:
        # a rank outside the mesh loads nothing
        return np.empty((0,), np.int64)
    return np.concatenate([
        np.arange(c * per_shard, (c + 1) * per_shard) for c in coords])


def host_local_batch_slice(global_batch: int, mesh) -> slice:
    """Contiguous form of ``host_local_batch_indices``; raises if this
    rank's rows are not contiguous (use host_local_batch_indices then)."""
    idx = host_local_batch_indices(global_batch, mesh)
    if len(idx) == 0:
        return slice(0, 0)
    if not np.array_equal(idx, np.arange(idx[0], idx[-1] + 1)):
        raise ValueError("host rows are non-contiguous on this mesh; "
                         "use host_local_batch_indices")
    return slice(int(idx[0]), int(idx[-1]) + 1)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(batch, mesh, batch_dim: int = 0):
    """This rank's rows (``host_local_batch_indices`` along
    ``batch_dim``) of a global host batch, on the rank's device.  There is
    no global array: the other rows stay with the other ranks."""
    dev = mesh_device(mesh)

    def rows(x):
        x = torch.as_tensor(np.asarray(x)) if not torch.is_tensor(x) else x
        if x.dim() <= batch_dim:
            return x.to(dev)
        idx = torch.from_numpy(host_local_batch_indices(x.shape[batch_dim],
                                                        mesh))
        return x.index_select(batch_dim, idx.to(x.device)).to(dev)

    return _map(rows, batch)


def make_global_batch(local_batch, mesh, batch_dim: int = 1):
    """The counterpart of the JAX assembly of per-host rows into global
    arrays: here a rank keeps its rows (``local_batch``, in
    host_local_batch_indices order) as tensors on its own device; the
    global batch exists only as the union of the ranks' rows."""
    dev = mesh_device(mesh)
    return _map(lambda x: torch.as_tensor(np.asarray(x)).to(dev),
                local_batch)


def replicate_tree(tree, mesh):
    """Broadcast every tensor of ``tree`` (modules' parameters and
    buffers included) from rank 0 of the mesh in place, so every rank
    holds rank 0's values."""
    from sdbc_tpu_torch.parallel import comm

    def bcast(x):
        if isinstance(x, torch.nn.Module):
            for t in list(x.parameters()) + list(x.buffers()):
                comm.broadcast_(t.data, None)
        elif torch.is_tensor(x):
            comm.broadcast_(x.data if isinstance(x, torch.nn.Parameter)
                            else x, None)
        return x

    return _map(bcast, tree)


def replicate_tree_global(tree, mesh):
    """``replicate_tree`` over the whole mesh: with one process per card
    the single- and multi-host forms are the same broadcast."""
    return replicate_tree(tree, mesh)

"""The ('data', 'model') mesh over ``torch.distributed``, and the collectives
of the parallel paths.

Port of ``detectorch_tpu/parallel/mesh.py``. The JAX package builds a
``jax.sharding.Mesh`` whose ``data`` axis splits the batch and whose
``model`` axis splits fc6/fc7's output rows, and XLA inserts the
collectives. Here one process runs per card (``torchrun``), the mesh is a
``DeviceMesh`` over the process group with the same axis names (rank
``i * model + j`` is data rank i, model rank j, the order of JAX's
``reshape(data, model)``), and the collectives are explicit:

  * training: each data rank runs its rows of the global batch, and after
    the backward the gradients are averaged over the ranks in flat buckets
    (``average_gradients``), so the step's loss is the mean of the
    per-image losses over the global batch, as JAX's is;
  * model > 1: fc6/fc7 hold the rank's rows of their output dimension and
    run column-parallel (``column_parallel``, used by
    ``models.heads.mlp_box_head``): the rank's slice of the product, then
    a gather over ``model``;
  * inference: ``make_batched_inference_fn`` runs the rank's rows and
    returns the full batch's outputs on every rank.

Every collective is an ``all_reduce`` (a gather is the sum of zero-filled
slices, which is exact): with ``broadcast`` the one collective that the
gloo backend runs on CUDA tensors, so one code path runs on NCCL and on
gloo. Collecting host objects (eval results) uses ``all_gather_object``.
Without a process group the mesh is 1x1 and every collective is the
identity.
"""

from __future__ import annotations

import os
from datetime import timedelta
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

AXES = ("data", "model")
# the box head's fully connected layers: the only weights that shard over
# 'model' (fc6 is (1024, 12544), ~12.8M parameters)
SHARDED_FC = ("fc6", "fc7")
# flat all-reduce buckets: the R-50-FPN model's ~44M fp32 gradients fit in one
BUCKET_BYTES = 256 << 20


def init_distributed_from_env(backend: Optional[str] = None,
                              init_method: Optional[str] = None,
                              timeout_s: Optional[float] = None) -> bool:
    """Join the process group that torchrun's environment describes
    (RANK, WORLD_SIZE, LOCAL_RANK; MASTER_ADDR and MASTER_PORT for the
    default ``env://`` rendezvous). Without RANK and WORLD_SIZE this is a
    single-process run and a no-op that returns False, as JAX's hook
    returns False without a coordinator.

    The backend is NCCL when a CUDA device is present and gloo otherwise,
    unless `backend` says; with a CUDA device the process's current device
    becomes ``cuda:LOCAL_RANK``. `init_method` replaces the env://
    rendezvous (the tests use a ``file://`` path). Returns True once the
    group exists."""
    if dist.is_initialized():
        return True
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return False
    cuda = torch.cuda.is_available()
    if cuda:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    kwargs = {} if timeout_s is None else {"timeout": timedelta(seconds=timeout_s)}
    dist.init_process_group(backend or ("nccl" if cuda else "gloo"),
                            init_method=init_method or "env://",
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]), **kwargs)
    return True


class Mesh:
    """This process's place on the ('data', 'model') mesh: ``shape`` is
    JAX's {'data': d, 'model': m}, ``coords`` this rank's {'data': i,
    'model': j}, ``device`` where its tensors live. ``device_mesh`` is the
    ``DeviceMesh`` whose groups the collectives use, or None for the 1x1
    mesh of a run without a process group."""

    def __init__(self, data: int, model: int, device, device_mesh=None):
        self.shape = {"data": data, "model": model}
        self.device = torch.device(device)
        self.device_mesh = device_mesh
        self.rank = dist.get_rank() if device_mesh is not None else 0
        self.coords = {"data": self.rank // model, "model": self.rank % model}

    def size(self, axis: Optional[str]) -> int:
        """Ranks along `axis`; None is every rank."""
        return self.shape["data"] * self.shape["model"] if axis is None else self.shape[axis]

    def group(self, axis: Optional[str]):
        """The process group of this rank's `axis` (None: every rank)."""
        return dist.group.WORLD if axis is None else self.device_mesh.get_group(axis)

    def __repr__(self):
        return f"Mesh({self.shape}, rank {self.rank} at {self.coords}, {self.device})"


def default_device() -> torch.device:
    """The current CUDA device. Without a card this raises: a caller that
    means the CPU says so (``make_mesh(device="cpu")``), and nothing falls
    back to it."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device (torch.cuda.is_available() is False); pass "
                           "device='cpu' to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def make_mesh(data_parallel: Optional[int] = None, model_parallel: int = 1,
              device=None) -> Mesh:
    """The mesh over every rank of the process group: ('data', 'model'),
    `data_parallel` defaulting to world / model_parallel. Without a process
    group, the 1x1 mesh. `device` defaults to ``default_device()``, which
    raises without a card."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if data_parallel is None:
        data_parallel = world // model_parallel
    if data_parallel * model_parallel != world:
        raise ValueError(f"mesh {data_parallel} x {model_parallel} does not cover "
                         f"{world} rank(s)")
    device = torch.device(device) if device is not None else default_device()
    if not dist.is_initialized():
        return Mesh(1, 1, device)
    from torch.distributed.device_mesh import DeviceMesh

    ranks = torch.arange(world).reshape(data_parallel, model_parallel)
    dm = DeviceMesh(device.type, ranks, mesh_dim_names=AXES)
    return Mesh(data_parallel, model_parallel, device, dm)


# -- parameters ---------------------------------------------------------------

def param_sharding(params: Dict, mesh: Mesh) -> Dict[str, tuple]:
    """JAX's rule, as partition specs: ``("model", None)`` for fc6_w/fc7_w
    (stored (out, in): the out rows split over 'model') and ``("model",)``
    for fc6_b/fc7_b, when 'model' > 1 and divides the rows; ``()``
    (replicated) for every other leaf. Model rank j holds rows
    [j * rows / m, (j + 1) * rows / m)."""
    m = mesh.shape["model"]
    specs = {}
    for name, v in params.items():
        layer, _, kind = name.rpartition("_")
        sharded = m > 1 and layer in SHARDED_FC and kind in ("w", "b") and v.shape[0] % m == 0
        specs[name] = (("model", None) if kind == "w" else ("model",)) if sharded else ()
    return specs


def _my_rows(v: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    n, i = mesh.shape[axis], mesh.coords[axis]
    if v.shape[0] % n:
        raise ValueError(f"{v.shape[0]} rows do not split over {axis} {n}")
    k = v.shape[0] // n
    return v[i * k:(i + 1) * k]


def shard_params(params: Dict, mesh: Mesh) -> Dict[str, torch.Tensor]:
    """This rank's params on ``mesh.device``: its model rows of the leaves
    that ``param_sharding`` shards, every other leaf whole."""
    specs = param_sharding(params, mesh)
    out = {}
    for name, v in params.items():
        v = torch.as_tensor(v)
        if specs[name]:
            v = _my_rows(v, mesh, "model").clone()
        out[name] = v.to(mesh.device)
    return out


def unshard_params(params: Dict[str, torch.Tensor], mesh: Mesh,
                   sharded: Sequence[str]) -> Dict[str, torch.Tensor]:
    """The inverse of ``shard_params`` for the leaves named in `sharded`:
    their rows gathered over 'model', on every rank (a collective)."""
    names = [k for k in sharded if k in params]
    full = gather_rows([params[k] for k in names], mesh, "model")
    out = dict(params)
    out.update(zip(names, full))
    return out


# -- collectives ----------------------------------------------------------------

def _wide(dtype: torch.dtype) -> torch.dtype:
    """The dtype that carries `dtype` exactly through a summed all-reduce."""
    if dtype == torch.float64:
        return torch.float64
    return torch.float32 if dtype.is_floating_point else torch.int64


def _buckets(tensors, bucket_bytes: int):
    """Tensors grouped by their carrying dtype, in order, each group cut
    into runs of at most `bucket_bytes` (a larger tensor is a run alone)."""
    by_dtype: Dict[torch.dtype, list] = {}
    for t in tensors:
        by_dtype.setdefault(_wide(t.dtype), []).append(t)
    for dtype, ts in by_dtype.items():
        run, size = [], 0
        for t in ts:
            nbytes = t.numel() * dtype.itemsize
            if run and size + nbytes > bucket_bytes:
                yield dtype, run
                run, size = [], 0
            run.append(t)
            size += nbytes
        if run:
            yield dtype, run


def _all_reduce_in_place(tensors, mesh: Mesh, axis: Optional[str], mean: bool) -> None:
    """Sum (or average) each tensor over `axis` in place: one all-reduce
    per flat bucket."""
    if mesh.device_mesh is None:
        return
    group = mesh.group(axis)
    n = mesh.size(axis)
    for dtype, run in _buckets(tensors, BUCKET_BYTES):
        flat = torch.cat([t.reshape(-1).to(dtype) for t in run])
        dist.all_reduce(flat, group=group)
        if mean:
            # a tensor divisor: division by a Python number is a reciprocal
            # multiply on CUDA
            flat = flat / torch.full((), n, dtype=dtype, device=flat.device)
        for t, part in zip(run, flat.split([t.numel() for t in run])):
            t.copy_(part.view(t.shape))


def all_reduce_mean(tensors, mesh: Mesh, axis: Optional[str] = "data") -> None:
    """Replace each tensor by its mean over the ranks of `axis` ('data',
    'model', or None for every rank), in flat buckets of one dtype."""
    _all_reduce_in_place(tensors, mesh, axis, True)


def all_reduce_sum(tensors, mesh: Mesh, axis: Optional[str] = "data") -> None:
    """Replace each tensor by its sum over the ranks of `axis`."""
    _all_reduce_in_place(tensors, mesh, axis, False)


def gather_rows(tensors, mesh: Mesh, axis: str = "data", dim: int = 0):
    """Each tensor's slices from every rank of `axis`, concatenated in rank
    order along `dim`, on every rank: an all-reduce of zero-filled tensors
    with this rank's slice in place (exact: every other term is zero)."""
    n, i = mesh.shape[axis], mesh.coords[axis]
    if mesh.device_mesh is None or n == 1:
        return list(tensors)
    full = []
    for t in tensors:
        shape = list(t.shape)
        k = shape[dim]
        shape[dim] = n * k
        f = t.new_zeros(shape)
        f.narrow(dim, i * k, k).copy_(t)
        full.append(f)
    all_reduce_sum(full, mesh, axis)
    return full


def all_gather_objects(obj, mesh: Mesh) -> list:
    """`obj` of every rank, in rank order (host objects, pickled)."""
    if mesh.device_mesh is None:
        return [obj]
    out = [None] * mesh.size(None)
    dist.all_gather_object(out, obj)
    return out


def _flatten(tree):
    """(leaves, rebuild) of nested tuples, NamedTuples, lists and dicts of
    tensors and None."""
    if isinstance(tree, torch.Tensor):
        return [tree], lambda leaves: leaves[0]
    if tree is None:
        return [], lambda leaves: None
    if isinstance(tree, dict):
        keys = list(tree)
        parts = [_flatten(tree[k]) for k in keys]
    elif isinstance(tree, (tuple, list)):
        keys = None
        parts = [_flatten(v) for v in tree]
    else:
        raise TypeError(f"cannot gather a {type(tree).__name__}")
    sizes = [len(leaves) for leaves, _ in parts]

    def rebuild(leaves):
        vals, at = [], 0
        for (_, sub), size in zip(parts, sizes):
            vals.append(sub(leaves[at:at + size]))
            at += size
        if keys is not None:
            return dict(zip(keys, vals))
        if hasattr(tree, "_fields"):
            return type(tree)(*vals)
        return type(tree)(vals)

    return [leaf for leaves, _ in parts for leaf in leaves], rebuild


def gather_batch(tree, mesh: Mesh):
    """Every data rank's rows of the batch-major tensors of `tree` (e.g.
    ``ModelOutputs``), in data-rank order, on every rank; dtypes kept."""
    leaves, rebuild = _flatten(tree)
    return rebuild(gather_rows(leaves, mesh, "data"))


def average_gradients(params: Dict[str, torch.Tensor], mesh: Mesh,
                      sharded: Sequence[str] = ()) -> None:
    """After a backward over this rank's rows: every trainable leaf's
    ``.grad`` becomes the mean over the data ranks (a zero gradient first
    where the loss did not reach a leaf). Replicated leaves average over
    every rank (their model peers computed the same gradient, so this is
    the data mean, and it leaves one value on all ranks); the leaves in
    `sharded` hold model rows and average over 'data' alone."""
    trainable = [(k, p) for k, p in params.items() if p.requires_grad]
    for _, p in trainable:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    sharded = set(sharded)
    all_reduce_mean([p.grad for k, p in trainable if k not in sharded], mesh, None)
    all_reduce_mean([p.grad for k, p in trainable if k in sharded], mesh, "data")


# -- the model axis (column-parallel fc6/fc7) ------------------------------------

class _ToModel(torch.autograd.Function):
    """Identity forward; the input's gradient summed over 'model' (each
    model rank's product saw only its output columns)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        all_reduce_sum([g], ctx.mesh, "model")
        return g, None


class _FromModel(torch.autograd.Function):
    """The model ranks' column slices gathered along the last dimension;
    the gradient's own columns going back."""

    @staticmethod
    def forward(ctx, y, mesh):
        ctx.mesh = mesh
        ctx.cols = y.shape[-1]
        return gather_rows([y.contiguous()], mesh, "model", dim=y.dim() - 1)[0]

    @staticmethod
    def backward(ctx, g):
        j = ctx.mesh.coords["model"]
        return g.narrow(-1, j * ctx.cols, ctx.cols).contiguous(), None


def column_parallel(x: torch.Tensor, mesh: Mesh,
                    product: Callable[[torch.Tensor], torch.Tensor]) -> torch.Tensor:
    """A product whose weight rows split over 'model': `product(x)` gives
    this rank's output columns, and every rank gets all of them."""
    return _FromModel.apply(product(_ToModel.apply(x, mesh)), mesh)


# -- batches and inference -----------------------------------------------------

def shard_batch(mesh: Mesh, *arrays):
    """This data rank's rows of each (numpy or tensor) array's leading
    axis, as tensors on ``mesh.device``."""
    return tuple(_my_rows(torch.as_tensor(np.asarray(a) if not isinstance(a, torch.Tensor)
                                          else a), mesh, "data").to(mesh.device)
                 for a in arrays)


def make_batched_inference_fn(cfg, test_cfg, mesh: Mesh):
    """The data-split inference program: fn(params, images, im_scale,
    orig_h, orig_w[, proposals, proposals_valid]) takes this rank's rows
    (``shard_batch``) and params (``shard_params``) and returns the
    ``ModelOutputs`` of the global batch, rows in data-rank order, on
    every rank."""
    from detectorch_tpu_torch.models.detector import make_inference_fn

    single = make_inference_fn(cfg, test_cfg, mesh=mesh)

    def fn(params, *rows):
        return gather_batch(single(params, *rows), mesh)

    return fn

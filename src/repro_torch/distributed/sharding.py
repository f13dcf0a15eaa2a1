"""Sharding rules of the port: the parameter, optimizer, batch and cache
specs of the JAX package's ``distributed/sharding.py``, rule for rule, and
the runtime that keeps a train state in those placements.

A spec is a tuple with one entry per tensor dimension: an axis name, a
tuple of axis names (one dimension split over several mesh axes, the first
one major) or ``None``; what ``tuple(PartitionSpec(...))`` gives in the
reference (a one-name tuple is the name, an empty one ``None``).  The rules
read only a mesh's axis names and sizes, so they take a :class:`MeshShape`
(``mesh_shape`` converts a ``DeviceMesh`` or ``launch.mesh``'s
``production_mesh_shape`` pair): the 256- and 512-device meshes' specs are
computed without 256 ranks.  ``to_placements`` maps a spec onto a
``DeviceMesh`` as DTensor ``Shard`` / ``Replicate`` placements.

Baseline placement (the reference's): heads / d_ff / vocab over ``model``,
experts over ``model`` where their count divides it, the batch over
``data`` (and ``pod``), ZeRO extension of the optimizer moments over
``data`` (and of the parameters too for configs of 32B and more), decode
caches batch over the data axes or, for a batch of one, sequence over
``data``.  Rules are name-based over the joined tree paths
(``"blocks.0.attn.wq"``); a ``blocks`` leaf's leading group dimension is
left unsharded by the rule (ZeRO may still take it).

The runtime does not do what GSPMD does with these specs.  The *state*
(parameters, moments, accumulator) lives in them as DTensors; the *compute*
is data parallel on plain tensors, with no tensor parallelism: the
``model`` axis shards storage only.  A parameter is unsharded at use
(:class:`Sharded` leaves, which ``models/lm.py`` gathers one superblock
group at a time inside the group's remat) and its gradient is reduced back
into its placements: summed over the batch axes (a reduce-scatter where
the leaf is sharded over them, an all-reduce where it is replicated) and
only sliced over ``model``, whose ranks computed the same batch.
:func:`batch_parallel` tells the model which mesh it runs on (the MoE
layer's global dispatch and the loss's global token count read it).
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..configs.base import ArchConfig, ShapeConfig

Spec = Tuple[Any, ...]


class MeshShape(NamedTuple):
    """A mesh's axis names and sizes, all the rules read of it."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    def size(self, name: str) -> int:
        return self.sizes[self.axis_names.index(name)] if name in self.axis_names else 1


def mesh_shape(mesh) -> MeshShape:
    """A ``MeshShape`` of ``mesh``: a ``MeshShape``, a ``DeviceMesh``, or a
    ``(sizes, axis_names)`` pair as ``launch.mesh.production_mesh_shape``
    returns it."""
    if isinstance(mesh, MeshShape):
        return mesh
    if hasattr(mesh, "mesh_dim_names"):
        return MeshShape(tuple(mesh.mesh_dim_names), tuple(int(s) for s in mesh.shape))
    sizes, names = mesh
    return MeshShape(tuple(names), tuple(int(s) for s in sizes))


def _axis(mesh, name: str) -> int:
    return mesh_shape(mesh).size(name)


def P(*axes) -> Spec:
    """A spec as ``tuple(PartitionSpec(*axes))`` gives it: a list or tuple
    entry becomes a tuple, one name alone its name, none ``None``."""
    out = []
    for ax in axes:
        if isinstance(ax, (tuple, list)):
            ax = tuple(ax)
            ax = None if not ax else ax[0] if len(ax) == 1 else ax
        out.append(ax)
    return tuple(out)


def batch_axes(mesh):
    return ("pod", "data") if "pod" in mesh_shape(mesh).axis_names else ("data",)


def _maybe(axis: str, dim: int, mesh) -> Optional[str]:
    """Shard only when divisible (the reference's rule: uneven GSPMD padding
    wastes memory on exactly the big cells where it hurts)."""
    return axis if dim % _axis(mesh, axis) == 0 else None


def param_spec(path: str, shape: Tuple[int, ...], cfg: ArchConfig, mesh) -> Spec:
    """The spec of one parameter leaf (``path`` is the joined key string)."""
    in_blocks = ".blocks." in path or path.startswith("blocks.")
    lead: Tuple[Optional[str], ...] = (None,) if in_blocks else ()
    body = shape[1:] if in_blocks else shape

    def ps(*axes):
        return P(*(lead + axes))

    if "embed" in path:
        return P(_maybe("model", shape[0], mesh), None)
    if "lm_head" in path:
        return P(None, _maybe("model", shape[1], mesh))
    if "final_norm" in path:
        return P(None)
    if ".attn." in path or "attn" in path.split(".")[-2:]:
        # the flat (heads * hd) dim only where the head count divides the axis
        if path.endswith("wo"):
            return ps(_maybe("model", cfg.n_heads, mesh), None)
        if path.endswith("wq"):
            return ps(None, _maybe("model", cfg.n_heads, mesh))
        if path.endswith(("wk", "wv")):
            return ps(None, _maybe("model", cfg.n_kv_heads, mesh))
    if "moe" in path:
        if path.endswith("router"):
            return ps(None, None)
        ep = _maybe("model", body[0], mesh)  # expert dim
        if path.endswith(("w_gate", "w_up")):
            return ps(ep, None, None if ep else _maybe("model", body[2], mesh))
        if path.endswith("w_down"):
            return ps(ep, None if ep else _maybe("model", body[1], mesh), None)
    if "mlp" in path:  # dense or shared expert
        if path.endswith(("w_gate", "w_up")):
            return ps(None, _maybe("model", body[1], mesh))
        if path.endswith("w_down"):
            return ps(_maybe("model", body[0], mesh), None)
    if "mamba" in path:
        if path.endswith("in_proj"):
            return ps(None, _maybe("model", body[1], mesh))
        if path.endswith("out_proj"):
            return ps(_maybe("model", body[0], mesh), None)
        if path.endswith("conv_w"):
            return ps(None, _maybe("model", body[1], mesh))
        if path.endswith(("conv_b", "norm_w")):
            return ps(_maybe("model", body[0], mesh))
        if path.endswith(("A_log", "D", "dt_bias")):
            return ps(_maybe("model", body[0], mesh))
    if path.endswith(("ln1", "ln2")):
        return ps(None)
    return P(*((None,) * len(shape)))  # fallback: replicate


# ---------------------------------------------------------------- trees


def tree_map_with_path(fn, tree, *rest, path: str = ""):
    """``fn(path, leaf, *rest_leaves)`` over a dict / list / tuple tree (and
    trees of the same structure in ``rest``), paths joined as the
    reference's ``_path_str`` joins them."""
    join = (lambda k: f"{path}.{k}") if path else str
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, *(r[k] for r in rest), path=join(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, *(r[i] for r in rest), path=join(i)) for i, v in enumerate(tree))
    return fn(path, tree, *rest)


def _leaf_map(fn, tree, *rest):
    return tree_map_with_path(lambda _, *leaves: fn(*leaves), tree, *rest)


def param_specs(cfg: ArchConfig, params_shape, mesh):
    """The spec tree of a parameter tree (tensors or anything with
    ``.shape``; the meta device's ``lm.init`` allocates nothing)."""

    def spec(path, leaf):
        sp = param_spec(path, tuple(leaf.shape), cfg, mesh)
        if cfg.fsdp:  # ZeRO-3: the parameters too, gathered at use
            sp = zero_extend(sp, tuple(leaf.shape), mesh)
        return sp

    return tree_map_with_path(spec, params_shape)


def zero_extend(spec: Spec, shape: Tuple[int, ...], mesh) -> Spec:
    """ZeRO: additionally shard one unsharded, divisible dim over ``data``
    (nothing if the spec already uses the data axis)."""
    d = _axis(mesh, "data")
    axes = list(spec) + [None] * (len(shape) - len(spec))
    if any(ax == "data" or (isinstance(ax, tuple) and "data" in ax) for ax in axes):
        return P(*axes)
    for i, (ax, dim) in enumerate(zip(axes, shape)):
        if ax is None and dim % d == 0 and dim >= d:
            axes[i] = "data"
            return P(*axes)
    return P(*axes)


def opt_specs(cfg: ArchConfig, opt_shape, pspecs, mesh, zero: bool = True):
    """The optimizer state's specs: each moment follows its parameter (the
    spec truncated to the moment's rank and checked against its shape, as
    Adafactor's ``vr`` / ``vc`` drop trailing dims), ZeRO-extended over
    ``data`` where ``zero``."""
    out = {}
    for key, sub in opt_shape.items():
        if key == "step":
            out[key] = P()
        elif key in ("m", "v", "vr", "vc"):
            out[key] = _leaf_map(lambda leaf, sp: _fit_spec(sp, leaf, mesh, zero), sub, pspecs)
        else:
            out[key] = _leaf_map(lambda leaf: P(*((None,) * leaf.dim())), sub)
    return out


def _fit_spec(sp: Spec, leaf, mesh, zero: bool) -> Spec:
    ndim = len(leaf.shape)
    axes = list(sp)[:ndim] + [None] * max(0, ndim - len(sp))
    for i, (ax, dim) in enumerate(zip(axes, leaf.shape)):
        if ax is not None and dim % _mesh_size(mesh, ax) != 0:
            axes[i] = None
    spec = P(*axes)
    return zero_extend(spec, tuple(leaf.shape), mesh) if zero else spec


def _mesh_size(mesh, ax) -> int:
    """The shard count of a spec entry (the product over a tuple of axes)."""
    return math.prod(_axis(mesh, a) for a in ax) if isinstance(ax, tuple) else _axis(mesh, ax)


def batch_spec(cfg: ArchConfig, shape: ShapeConfig, mesh) -> Dict[str, Optional[Spec]]:
    ba = batch_axes(mesh)
    tok = P(ba, None)
    if cfg.frontend != "none":
        return {"tokens": None, "embeds": P(ba, None, None), "labels": tok}
    return {"tokens": tok, "embeds": None, "labels": tok}


def cache_specs(cfg: ArchConfig, shape: ShapeConfig, mesh, cache_shape):
    """Decode-cache specs: batch over the data axes; the sequence over
    ``data`` for a batch of one (context parallelism); heads / state over
    ``model`` where divisible."""
    ba = batch_axes(mesh)
    dp = math.prod(_axis(mesh, a) for a in ba)
    batch_sharded = shape.global_batch % dp == 0 and shape.global_batch >= dp

    def spec_of(path, leaf):
        last = path.split(".")[-1]
        shp = tuple(leaf.shape)
        if last in ("k", "v"):  # (G, B, S, Hkv, hd)
            b_ax = ba if batch_sharded else None
            s_ax = None
            if not batch_sharded and shp[2] % _axis(mesh, "data") == 0 and shp[2] > 1:
                s_ax = "data"
            return P(None, b_ax, s_ax, _maybe("model", shp[3], mesh), None)
        if last == "h":  # (G, B, H, P, N)
            return P(None, ba if batch_sharded else None, _maybe("model", shp[2], mesh), None, None)
        if last == "conv":  # (G, B, K-1, ch)
            return P(None, ba if batch_sharded else None, None, _maybe("model", shp[3], mesh))
        return P(*((None,) * len(shp)))

    return tree_map_with_path(spec_of, cache_shape)


# ------------------------------------------------------ specs as placements


class Layout:
    """Where one leaf lives: a ``DeviceMesh`` and one DTensor placement per
    mesh dimension (a leaf of the port's trees, unlike a tuple)."""

    __slots__ = ("mesh", "placements")

    def __init__(self, mesh, placements):
        self.mesh, self.placements = mesh, tuple(placements)

    def __repr__(self):
        return f"Layout({tuple(self.mesh.mesh_dim_names)}, {self.placements})"


def to_placements(spec: Spec, mesh) -> Tuple:
    """The DTensor placements of ``spec`` on the ``DeviceMesh`` ``mesh``:
    ``Shard(d)`` on each mesh dimension whose axis names tensor dim ``d``,
    ``Replicate()`` on the others.  A dim split over several axes is split
    over each of their mesh dimensions, which DTensor nests in mesh order
    (the first major), the reference's row-major split: the axes must come
    in the mesh's order."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    owner: Dict[str, int] = {}
    for d, ax in enumerate(spec):
        axes = () if ax is None else ax if isinstance(ax, tuple) else (ax,)
        unknown = sorted(set(axes) - set(names))
        if unknown:
            raise ValueError(f"spec {spec} names axes {unknown} the mesh {names} does not have")
        if [names.index(a) for a in axes] != sorted(names.index(a) for a in axes):
            raise ValueError(f"spec {spec}: the axes of dim {d} must follow the mesh's order {names}")
        for a in axes:
            if a in owner:
                raise ValueError(f"spec {spec}: mesh axis {a!r} shards two dims")
            owner[a] = d
    return tuple(Shard(owner[n]) if n in owner else Replicate() for n in names)


def from_placements(placements: Sequence, ndim: int, mesh) -> Spec:
    """The spec of ``placements`` on ``mesh`` (``to_placements``' inverse)."""
    names = tuple(mesh.mesh_dim_names)
    axes: List[List[str]] = [[] for _ in range(ndim)]
    for n, pl in zip(names, placements):
        if pl.is_shard():
            axes[pl.dim].append(n)
    return P(*axes)


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, (str, tuple)) for a in x)


def spec_tree_map(fn, specs):
    """``fn(spec)`` over a spec tree, a spec being a leaf."""
    if _is_spec(specs):
        return fn(specs)
    if isinstance(specs, dict):
        return {k: spec_tree_map(fn, v) for k, v in specs.items()}
    if specs is None:
        return None
    return type(specs)(spec_tree_map(fn, v) for v in specs)


def spec_layouts(specs, mesh):
    """A spec tree as a tree of :class:`Layout` on ``mesh`` (``None``
    stays ``None``)."""
    return spec_tree_map(lambda sp: Layout(mesh, to_placements(sp, mesh)), specs)


def shard_slices(shape: Sequence[int], layout: Layout, coords: Optional[Sequence[int]] = None) -> Tuple[slice, ...]:
    """This rank's block of a tensor of ``shape`` in ``layout``: one slice a
    dim, the dims split evenly over their mesh dimensions in mesh order.
    ``coords`` default to this rank's mesh coordinate."""
    mesh = layout.mesh
    coords = mesh.get_coordinate() if coords is None else coords
    sizes = tuple(int(s) for s in mesh.shape)
    index = [0] * len(shape)
    parts = [1] * len(shape)
    for md, pl in enumerate(layout.placements):
        if pl.is_shard():
            index[pl.dim] = index[pl.dim] * sizes[md] + coords[md]
            parts[pl.dim] *= sizes[md]
    out = []
    for d, n in enumerate(shape):
        if n % parts[d]:
            raise ValueError(f"dim {d} of {tuple(shape)} does not split evenly in {parts[d]}")
        k = n // parts[d]
        out.append(slice(index[d] * k, (index[d] + 1) * k))
    return tuple(out)


def local_shape(shape: Sequence[int], layout: Layout) -> Tuple[int, ...]:
    sl = shard_slices(shape, layout, [0] * layout.mesh.ndim)
    return tuple(s.stop - s.start for s in sl)


def _contiguous_stride(shape) -> Tuple[int, ...]:
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def dtensor(local: torch.Tensor, layout: Layout, shape: Sequence[int]):
    """A DTensor of global ``shape`` in ``layout`` over this rank's block
    ``local`` (no communication)."""
    from torch.distributed.tensor import DTensor

    shape = tuple(int(s) for s in shape)
    return DTensor.from_local(local, layout.mesh, layout.placements, run_check=False, shape=shape,
                              stride=_contiguous_stride(shape))


def distribute(full: torch.Tensor, layout: Layout, copy: bool = True):
    """The DTensor of ``full`` (a tensor every rank holds whole, e.g. drawn
    from one seed) in ``layout``: each rank keeps a copy of its block, no
    communication.  ``copy=False``: where the block is all of ``full``, the
    DTensor holds ``full`` itself (the caller gives it up)."""
    sl = shard_slices(full.shape, layout)
    whole = all(s.start == 0 and s.stop == n for s, n in zip(sl, full.shape))
    return dtensor(full if whole and not copy else full[sl].clone(), layout, full.shape)


def distribute_tree(tree, layout_tree, copy: bool = True):
    return _leaf_map(lambda x, lay: x if lay is None else distribute(x, lay, copy), tree, layout_tree)


def gather_tree(tree):
    """Each DTensor leaf of ``tree`` as its full tensor (all-gathered); other
    leaves as they are."""
    from torch.distributed.tensor import DTensor

    from ..checkpoint.manager import tree_flatten

    mesh = next((x.device_mesh for x in tree_flatten(tree)[0] if isinstance(x, DTensor)), None)
    with collectives(mesh) if mesh is not None else contextlib.nullcontext():
        return _leaf_map(lambda x: x.full_tensor() if isinstance(x, DTensor) else x, tree)


def shard_batch(batch: Dict[str, Any], mesh, microbatches: int = 1) -> Dict[str, Any]:
    """The global ``batch`` (every rank holds it whole) as DTensors split
    over the batch axes (``batch_spec``'s placements), each rank's block
    laid out microbatch by microbatch: microbatch ``i`` of the step is
    global rows ``[i*mb, (i+1)*mb)`` as in the reference's
    ``dynamic_slice``, and this rank's block holds its share of each, in
    order, so the step cuts its block in ``microbatches`` pieces."""
    ms = mesh_shape(mesh)
    ranks = math.prod(ms.size(a) for a in batch_axes(ms))
    coords = mesh.get_coordinate()
    r = 0
    for a in batch_axes(ms):
        r = r * ms.size(a) + coords[ms.axis_names.index(a)]
    out = {}
    for k, v in batch.items():
        if v is None:
            out[k] = None
            continue
        spec = P(batch_axes(ms), *((None,) * (v.dim() - 1)))
        lay = Layout(mesh, to_placements(spec, mesh))
        B = v.shape[0]
        if B % (ranks * microbatches):
            raise ValueError(f"a batch of {B} rows does not split in {microbatches} microbatches over {ranks} ranks")
        mb, share = B // microbatches, B // microbatches // ranks
        rows = torch.cat([v[i * mb + r * share : i * mb + (r + 1) * share] for i in range(microbatches)])
        out[k] = dtensor(rows.contiguous(), lay, v.shape)
    return out


# ------------------------------------------------------------- collectives


_STAGED = ("all_gather_into_tensor", "reduce_scatter_tensor", "all_reduce", "all_to_all_single")
_STAGING: List[bool] = []


@contextlib.contextmanager
def collectives(mesh):
    """Within: the functional collectives of a ``gloo`` mesh on CUDA tensors
    (ranks that share one card) run on host copies of their inputs, their
    outputs copied back; torch's ``gloo`` backend faults on a CUDA
    all-gather (torch 2.11), and stages every CUDA collective through the
    host anyway.  NCCL and CPU meshes, and a nested call, run as they are."""
    import torch.distributed as dist

    if _STAGING or mesh.device_type != "cuda" or dist.get_backend(mesh.get_group(0)) != "gloo":
        yield
        return
    from torch.utils._python_dispatch import TorchDispatchMode

    class _HostStaged(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if func.namespace == "_c10d_functional" and func._overloadpacket.__name__ in _STAGED and args[0].is_cuda:
                # into page-locked memory (the caching host allocator's): a pageable
                # copy of a GB-sized gradient took 10x longer on the card's host
                host = torch.empty(args[0].shape, dtype=args[0].dtype, pin_memory=True).copy_(args[0])
                out = func(host, *args[1:], **kwargs)
                return torch.ops._c10d_functional.wait_tensor(out).to(args[0].device)
            return func(*args, **kwargs)

    _STAGING.append(True)
    try:
        with _HostStaged():
            yield
    finally:
        _STAGING.pop()


def _dims(mesh, names) -> List[int]:
    return [i for i, n in enumerate(mesh.mesh_dim_names) if n in names]


def all_reduce(x: torch.Tensor, mesh, dims: Sequence[int], op: str = "sum") -> torch.Tensor:
    """``x`` reduced over the mesh dimensions ``dims`` (functional
    collectives, one a dimension; ``x`` itself where ``dims`` is empty)."""
    from torch.distributed import _functional_collectives as funcol

    for d in dims:
        if mesh.size(d) > 1:
            x = funcol.wait_tensor(funcol.all_reduce(x, op, (mesh, d)))
    return x


def shard_dims(layout: Layout, tensor_dims: Optional[Sequence[int]] = None) -> List[int]:
    """The mesh dimensions of more than one rank that split ``layout``'s
    leaf (only those that split one of ``tensor_dims`` where given)."""
    return [md for md, pl in enumerate(layout.placements)
            if pl.is_shard() and layout.mesh.size(md) > 1 and (tensor_dims is None or pl.dim in tensor_dims)]


def replica_dims(layout: Layout) -> List[int]:
    return [md for md, pl in enumerate(layout.placements) if not pl.is_shard() and layout.mesh.size(md) > 1]


def owns(layout: Layout) -> bool:
    """Whether this rank holds the first replica of its block (coordinate 0
    on every mesh dimension the leaf is replicated over)."""
    coords = layout.mesh.get_coordinate()
    return all(coords[md] == 0 for md in replica_dims(layout))


# ------------------------------------------------------ unshard / reduce


_BATCH: Dict[str, Any] = {}


@contextlib.contextmanager
def batch_parallel(mesh):
    """Within: the model runs data parallel over ``mesh``'s batch axes (the
    MoE layer dispatches the global token set, the loss divides by the
    global token count, ``batch_ranks`` counts them)."""
    prev = dict(_BATCH)
    ms = mesh_shape(mesh)
    _BATCH.clear()
    _BATCH.update(mesh=mesh, dims=_dims(mesh, batch_axes(ms)),
                  ranks=math.prod(ms.size(a) for a in batch_axes(ms)))
    try:
        yield
    finally:
        _BATCH.clear()
        _BATCH.update(prev)


def batch_ranks() -> int:
    """The ranks the batch is split over (1 outside ``batch_parallel``)."""
    return _BATCH.get("ranks", 1)


def batch_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the batch ranks (no gradient)."""
    return all_reduce(x, _BATCH["mesh"], _BATCH["dims"]) if _BATCH else x


def _reduce_grad(g: torch.Tensor, layout: Layout) -> torch.Tensor:
    """A full-size gradient, this rank's contribution, as this rank's block
    in ``layout``: sliced over the other axes first (no communication),
    then summed over the batch axes (a reduce-scatter or an all-reduce of
    the slice)."""
    from torch.distributed.tensor import Partial, Replicate

    mesh = layout.mesh
    bdims = [md for md in _dims(mesh, batch_axes(mesh_shape(mesh))) if mesh.size(md) > 1]
    own = Layout(mesh, [Replicate() if md in bdims else p for md, p in enumerate(layout.placements)])
    block = g[shard_slices(g.shape, own)]
    if not bdims:
        return block
    src = Layout(mesh, [Partial() if md in bdims else p for md, p in enumerate(layout.placements)])
    return dtensor(block.contiguous(), src, g.shape).redistribute(mesh, layout.placements).to_local()


class _Unshard(torch.autograd.Function):
    """The full tensor of a block (all-gathered); backward: the gradient
    reduced back into the block's layout (``_reduce_grad``)."""

    @staticmethod
    def forward(ctx, local, layout, shape):
        ctx.layout = layout
        if not shard_dims(layout):
            return local.detach()
        return dtensor(local, layout, shape).full_tensor()

    @staticmethod
    def backward(ctx, g):
        return _reduce_grad(g, ctx.layout), None, None


class _UnshardGroup(torch.autograd.Function):
    """Group ``g`` of a stacked block, whole.  Where ZeRO split the group
    dim, the group's owner contributes it and the others zeros, summed
    over those mesh dims (exact); backward: the group's gradient reduced
    into the owner's block, zeros elsewhere."""

    @staticmethod
    def forward(ctx, local, layout, shape, g):
        from torch.distributed.tensor import Partial, Replicate, Shard

        mesh = layout.mesh
        lead = shard_dims(layout, [0])
        n_local = local.shape[0]
        owner_idx, i = divmod(g, n_local)
        coords = mesh.get_coordinate()
        idx = 0
        for md in lead:
            idx = idx * mesh.size(md) + coords[md]
        mine = idx == owner_idx
        pl = tuple(Partial() if md in lead else Shard(p.dim - 1) if p.is_shard() and p.dim > 0 else Replicate()
                   for md, p in enumerate(layout.placements))
        ctx.layout, ctx.lead, ctx.mine, ctx.i, ctx.n_local = layout, lead, mine, i, n_local
        ctx.group = Layout(mesh, tuple(Replicate() if md in lead else p for md, p in enumerate(pl)))
        x = local[i]
        if not lead and not shard_dims(layout):
            return x.detach()
        if lead and not mine:
            x = torch.zeros_like(x)
        return dtensor(x.contiguous(), Layout(mesh, pl), shape[1:]).full_tensor()

    @staticmethod
    def backward(ctx, gr):
        block = _reduce_grad(gr, ctx.group)
        out = torch.zeros((ctx.n_local, *block.shape), dtype=block.dtype, device=block.device)
        if ctx.mine or not ctx.lead:
            out[ctx.i] = block
        return out, None, None, None


class Sharded:
    """A parameter leaf handed to the model as this rank's block: ``local``
    (the tensor autograd differentiates), its ``layout`` and global
    ``shape``.  The model calls ``unshard`` (or ``group``) where it uses
    the leaf."""

    __slots__ = ("local", "layout", "shape")

    def __init__(self, local: torch.Tensor, layout: Layout, shape):
        self.local, self.layout, self.shape = local, layout, torch.Size(shape)

    def group(self, g: int) -> "ShardedGroup":
        return ShardedGroup(self, g)


class ShardedGroup:
    """Group ``g`` of a stacked :class:`Sharded` leaf, not yet gathered."""

    __slots__ = ("leaf", "g")

    def __init__(self, leaf: Sharded, g: int):
        self.leaf, self.g = leaf, g


def unshard(x):
    """The whole tensor of a :class:`Sharded` leaf or group (gathered,
    autograd reduces its gradient into the block); anything else as it
    is."""
    if isinstance(x, Sharded):
        return _Unshard.apply(x.local, x.layout, x.shape)
    if isinstance(x, ShardedGroup):
        return _UnshardGroup.apply(x.leaf.local, x.leaf.layout, x.leaf.shape, x.g)
    return x


def unshard_tree(tree):
    return _leaf_map(unshard, tree)


def gather_batch(x: torch.Tensor) -> torch.Tensor:
    """Under ``batch_parallel``: ``x`` (this rank's rows) with every batch
    rank's rows, in rank order along dim 0; backward: the rows' gradients
    summed over the ranks and this rank's rows kept (a reduce-scatter).
    Outside: ``x``."""
    if not _BATCH or _BATCH["ranks"] == 1:
        return x
    from torch.distributed.tensor import Replicate, Shard

    mesh = _BATCH["mesh"]
    lay = Layout(mesh, [Shard(0) if md in _BATCH["dims"] else Replicate() for md in range(mesh.ndim)])
    return _Unshard.apply(x, lay, (x.shape[0] * _BATCH["ranks"], *x.shape[1:]))


def batch_rows(x: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a tensor ``gather_batch`` gathered."""
    if not _BATCH or _BATCH["ranks"] == 1:
        return x
    mesh = _BATCH["mesh"]
    coords = mesh.get_coordinate()
    r = 0
    for md in _BATCH["dims"]:
        r = r * mesh.size(md) + coords[md]
    n = x.shape[0] // _BATCH["ranks"]
    return x[r * n : (r + 1) * n]


# ------------------------------------------------------------ accounting


_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_to_all_single": "all-to-all",
    "broadcast": "broadcast",
}


def comm_counter(timed: bool = False):
    """A ``CommDebugMode`` that also records, per collective kind, the
    count, the bytes of each functional collective's output (the
    reference's measure of collective bytes) and, where ``timed``, the
    host milliseconds from issue to completion (the device synchronised
    around each: it serialises the step).  ``.by_kind`` after the run."""
    import time

    from torch.distributed.tensor.debug import CommDebugMode

    class _Counter(CommDebugMode):
        def __init__(self):
            super().__init__()
            self.by_kind: Dict[str, Dict[str, float]] = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kind = _KINDS.get(func._overloadpacket.__name__) if "c10d" in func.namespace else None
            if kind is None:
                return super().__torch_dispatch__(func, types, args, kwargs)
            dev = next((a.device for a in args if isinstance(a, torch.Tensor)), None)
            sync = timed and dev is not None and dev.type == "cuda"
            if sync:
                torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            out = super().__torch_dispatch__(func, types, args, kwargs)
            if timed:
                out = torch.ops._c10d_functional.wait_tensor(out)
                if sync:
                    torch.cuda.synchronize(dev)
            rec = self.by_kind.setdefault(kind, {"count": 0, "bytes": 0, "ms": 0.0})
            rec["count"] += 1
            rec["bytes"] += out.numel() * out.element_size()
            rec["ms"] += (time.perf_counter() - t0) * 1e3
            return out

    return _Counter()

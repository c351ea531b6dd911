"""Device mesh, explicit shards and the data- and vocab-parallel programs.

Port of ``rwkv_tts_tpu/parallel/mesh.py``. The JAX package builds a
``(data, model)`` ``jax.sharding.Mesh``, annotates placements and lets XLA
insert the collectives. PyTorch has neither GSPMD nor ``shard_map``, so
here every placement and every collective is explicit, and one process
drives the whole grid (as the JAX package's single controller does):

  * ``Mesh`` is a ``(data, model)`` grid of ``torch.device``s. A device may
    appear more than once: a *virtual* mesh (``["cpu"] * 8`` for the CPU
    tests, ``["cuda:0"] * k`` to run the sharded program on one card),
    the counterpart of the JAX tests' 8 virtual host devices;
  * a ``Sharded`` tensor is a plain grid of per-device pieces: a dim split
    over ``data`` is cut into ``dp`` pieces, a dim split over ``model``
    into ``mp``, and the other dims are whole (replicated) on every device;
  * ``psum`` over ``model`` is the sum of the shards' partials in shard
    order 0, 1, … (in f32), computed on each shard's device; across
    physical cards the partials move with ``.to(device)``. The fixed order
    gives a request the same bits whatever devices the grid holds;
  * ``data`` rows are independent: each runs its batch slice, and the
    programs hand back logits gathered on the mesh's first device.

Placement rules as the JAX package's (:40-72): ``shard_params`` puts the
embedding's rows and the head's columns over ``model`` and replicates the
rest; ``shard_state`` splits the state's batch over ``data``. A row-split
embedding and a column-split head compute each row and each logit as the
unsharded model does (``step_sharded``, the decode step of the continuous
engine's data rows, which prefills unsharded and splits the state). The
layer weights' tensor parallelism is ``parallel/tp.py``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..config import RwkvConfig
from ..models import rwkv7
from ..ops.quant import qmatmul

DATA_AXIS = "data"
MODEL_AXIS = "model"

Spec = Tuple[Optional[str], ...]


def visible_devices(platform: str = "cuda") -> List[torch.device]:
    """Every device a mesh may take: each CUDA card (raises without one,
    as ``utils/device.resolve_device`` does), or the one CPU. A virtual
    mesh repeats a device through ``make_mesh(devices=...)``."""
    if platform == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass CPU "
                               "devices to build a mesh on the CPU")
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    if platform == "cpu":
        return [torch.device("cpu")]
    raise ValueError(f"unsupported platform {platform!r}")


class Mesh:
    """A ``(data, model)`` grid of devices: ``devices[d][m]``. ``shape``
    maps each axis name to its size, as a JAX mesh's does."""

    def __init__(self, devices: Sequence[Sequence]):
        rows = tuple(tuple(torch.device(x) for x in row) for row in devices)
        if not rows or not rows[0] or any(len(r) != len(rows[0])
                                          for r in rows):
            raise ValueError("a mesh is a non-empty rectangular grid")
        kinds = {x.type for r in rows for x in r}
        if len(kinds) != 1 or not kinds <= {"cpu", "cuda"}:
            raise ValueError(f"a mesh holds CPU or CUDA devices, one kind: "
                             f"{sorted(kinds)}")
        self.devices = rows
        self.shape = {DATA_AXIS: len(rows), MODEL_AXIS: len(rows[0])}

    @property
    def dp(self) -> int:
        return self.shape[DATA_AXIS]

    @property
    def mp(self) -> int:
        return self.shape[MODEL_AXIS]

    @property
    def home(self) -> torch.device:
        """The device the programs gather their logits on."""
        return self.devices[0][0]

    def row(self, d: int) -> "Mesh":
        """Data row ``d`` alone: a ``(1, mp)`` mesh."""
        return Mesh([self.devices[d]])

    def __eq__(self, other):
        return isinstance(other, Mesh) and self.devices == other.devices

    def __hash__(self):
        return hash(self.devices)

    def __repr__(self):
        return f"Mesh(data={self.dp}, model={self.mp}, {self.devices})"


def make_mesh(n_devices: Optional[int] = None, model_parallel: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """A ``(data, model)`` mesh over the first ``n_devices`` of ``devices``
    (default: every visible CUDA card; raises without one). ``devices`` may
    repeat a device: a virtual mesh."""
    devs = visible_devices("cuda") if devices is None else \
        [torch.device(x) for x in devices]
    if n_devices is None:
        n_devices = len(devs)
    if n_devices > len(devs) or n_devices < 1:
        raise ValueError(f"{n_devices} devices asked for, {len(devs)} given")
    if n_devices % model_parallel:
        raise ValueError(f"{n_devices} devices not divisible by "
                         f"model_parallel={model_parallel}")
    dp = n_devices // model_parallel
    return Mesh([devs[d * model_parallel:(d + 1) * model_parallel]
                 for d in range(dp)])


# --------------------------------------------------------------------------
# sharded tensors
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class Sharded:
    """A global tensor of ``shape`` laid out over ``mesh`` by ``spec`` (an
    axis name or None per dim): ``grid[d][m]`` is the piece on
    ``mesh.devices[d][m]``."""

    grid: Tuple[Tuple[torch.Tensor, ...], ...]
    spec: Spec
    shape: Tuple[int, ...]
    mesh: Mesh

    def local(self, d: int, m: int) -> torch.Tensor:
        return self.grid[d][m]

    def row(self, d: int) -> "Sharded":
        """Data row ``d``'s pieces, over ``mesh.row(d)``; they are the same
        tensors, so in-place updates reach this grid."""
        shape = tuple(n // self.mesh.dp if a == DATA_AXIS else n
                      for n, a in zip(self.shape, self.spec))
        return Sharded((self.grid[d],), self.spec, shape,
                       self.mesh.row(d))

    @property
    def dtype(self) -> torch.dtype:
        return self.grid[0][0].dtype

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def shard_shape(self) -> Tuple[int, ...]:
        return tuple(self.grid[0][0].shape)

    @property
    def nbytes(self) -> int:
        """Bytes of the global (unsharded) tensor."""
        n = self.grid[0][0].element_size()
        for s in self.shape:
            n *= s
        return n

    def clone(self) -> "Sharded":
        """A copy with pieces of its own."""
        return dataclasses.replace(self, grid=tuple(
            tuple(p.clone() for p in row) for row in self.grid))

    def gather(self, device=None) -> torch.Tensor:
        """The global tensor, reassembled on ``device`` (default the mesh's
        first device)."""
        dev = self.mesh.home if device is None else torch.device(device)

        def along(pieces, axis):
            dims = [i for i, a in enumerate(self.spec) if a == axis]
            if not dims:
                return pieces[0]
            return torch.cat(pieces, dim=dims[0])

        rows = [along([p.to(dev) for p in row], MODEL_AXIS)
                for row in self.grid]
        return along(rows, DATA_AXIS)


def _piece(x: torch.Tensor, spec: Spec, mesh: Mesh, d: int, m: int):
    idx = []
    for dim, axis in enumerate(spec):
        if axis is None:
            idx.append(slice(None))
            continue
        parts = mesh.dp if axis == DATA_AXIS else mesh.mp
        n = x.shape[dim]
        if n % parts:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                             f"over the {axis} axis ({parts})")
        k = (d if axis == DATA_AXIS else m) * (n // parts)
        idx.append(slice(k, k + n // parts))
    return tuple(idx)


def shard(x, spec: Spec, mesh: Mesh, copies: bool = False) -> Sharded:
    """Split ``x`` over ``mesh`` by ``spec``. Every piece is contiguous on
    its device. Pieces with the same slice on the same device are one
    tensor (read-only weights) unless ``copies``: state that every shard
    updates in place needs a copy of its own. A ``Sharded`` already laid
    out so comes back unchanged."""
    spec = tuple(spec)
    if isinstance(x, Sharded):
        if x.mesh == mesh and x.spec == spec:
            return x
        x = x.gather()
    if len(spec) != x.ndim:
        raise ValueError(f"spec {spec} for a {x.ndim}-d tensor")
    seen: Dict[Tuple, torch.Tensor] = {}
    grid = []
    for d, row in enumerate(mesh.devices):
        pieces = []
        for m, dev in enumerate(row):
            idx = _piece(x, spec, mesh, d, m)
            key = (dev, tuple((s.start, s.stop) for s in idx))
            if copies or key not in seen:
                p = x[idx].to(dev)
                seen[key] = p.clone(memory_format=torch.contiguous_format) \
                    if copies else p.contiguous()
            pieces.append(seen[key])
        grid.append(tuple(pieces))
    return Sharded(tuple(grid), spec, tuple(x.shape), mesh)


def from_pieces(grid, spec: Spec, mesh: Mesh) -> Sharded:
    """A ``Sharded`` from per-device pieces laid out by ``spec``."""
    grid = tuple(tuple(row) for row in grid)
    shape = tuple(n * (mesh.dp if a == DATA_AXIS else
                       mesh.mp if a == MODEL_AXIS else 1)
                  for n, a in zip(grid[0][0].shape, spec))
    return Sharded(grid, tuple(spec), shape, mesh)


def tree_map(fn: Callable, tree):
    """``fn`` over the leaves (tensors and ``Sharded``) of a nested dict /
    list / tuple, keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def map_with_path(fn: Callable, tree, path=()):
    """``fn(path, leaf)`` over a tree's leaves; ``path`` is the tuple of
    keys (list and tuple positions as strings) from the root."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def local_tree(tree, d: int, m: int):
    """Shard (d, m)'s tree: each ``Sharded`` leaf's piece there."""
    return tree_map(lambda s: s.local(d, m), tree)


def row_tree(tree, d: int):
    """Data row ``d``'s tree (``Sharded.row`` of each leaf)."""
    return tree_map(lambda s: s.row(d), tree)


def shard_tree(tree, specs, mesh: Mesh, copies: bool = False):
    """``shard`` each leaf of ``tree`` by the spec at the same place in
    ``specs``."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, specs[k], mesh, copies)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard_tree(v, s, mesh, copies)
                          for v, s in zip(tree, specs))
    return shard(tree, specs, mesh, copies)


# --------------------------------------------------------------------------
# placement rules
# --------------------------------------------------------------------------

def param_sharding(mesh: Mesh, params):
    """The spec of each leaf: the embedding's rows [V, C] and the head's
    columns [C, V] (a quantized head's members alike) over ``model``, the
    rest replicated."""
    def rule(path, x):
        name = "/".join(path)
        spec = [None] * x.ndim
        if x.ndim >= 1 and "emb" in name:
            spec[0] = MODEL_AXIS
        elif x.ndim >= 1 and "head" in name:
            spec[-1] = MODEL_AXIS
        return tuple(spec)
    return map_with_path(rule, params)


def state_sharding(mesh: Mesh, state):
    """Recurrent state [L, B, …]: the batch over ``data``."""
    def rule(x):
        spec = [None] * x.ndim
        if x.ndim >= 2:
            spec[1] = DATA_AXIS
        return tuple(spec)
    return tree_map(rule, state)


def batch_sharding(mesh: Mesh, ndim: int) -> Spec:
    """Per-request arrays [B, …]: dim 0 over ``data``."""
    return (DATA_AXIS,) + (None,) * (ndim - 1)


def shard_params(mesh: Mesh, params):
    return shard_tree(params, param_sharding(mesh, params), mesh)


def shard_state(mesh: Mesh, state):
    return shard_tree(state, state_sharding(mesh, state), mesh, copies=True)


# --------------------------------------------------------------------------
# collectives and batch plumbing
# --------------------------------------------------------------------------

def psum(partials: Sequence[torch.Tensor], devices: Sequence[torch.device]
         ) -> List[torch.Tensor]:
    """All-reduce over one ``model`` row: shard m gets partials[0] +
    partials[1] + … in that order, summed in f32 on ``devices[m]`` and
    returned in the partials' dtype. Shards on one device share the
    result. One partial is returned as it is."""
    if len(partials) == 1:
        return [partials[0]]
    out, done = [], {}
    for dev in devices:
        if dev not in done:
            acc = partials[0].to(dev, torch.float32)
            for p in partials[1:]:
                acc = acc + p.to(dev, torch.float32)
            done[dev] = acc.to(partials[0].dtype)
        out.append(done[dev])
    return out


def split_batch(x: torch.Tensor, mesh: Mesh) -> List[torch.Tensor]:
    """[B, …] → one [B / dp, …] slice per data row, on the row's first
    device."""
    if x.shape[0] % mesh.dp:
        raise ValueError(f"batch {x.shape[0]} does not split over the data "
                         f"axis ({mesh.dp})")
    n = x.shape[0] // mesh.dp
    return [x[d * n:(d + 1) * n].to(row[0])
            for d, row in enumerate(mesh.devices)]


def gather_batch(rows: Sequence[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """The data rows' results concatenated on the mesh's first device."""
    return torch.cat([r.to(mesh.home) for r in rows])


# --------------------------------------------------------------------------
# the data- and vocab-parallel programs (parameters from shard_params)
# --------------------------------------------------------------------------

def _embed_rows(params, tokens, d: int, mesh: Mesh) -> List[torch.Tensor]:
    """Embedding rows of ``tokens`` for every shard of data row ``d`` from
    the row-split table: each shard looks up the ids it holds (zero
    elsewhere), and the psum adds one nonzero row to zeros, which is
    exact."""
    emb = params["emb"]
    rows_per = emb.shard_shape[0]
    devs = mesh.devices[d]
    parts = []
    for m, dev in enumerate(devs):
        t = tokens.to(dev)
        local = t - m * rows_per
        hit = (local >= 0) & (local < rows_per)
        rows = emb.local(d, m)[local.clamp(0, rows_per - 1)]
        parts.append(torch.where(hit[..., None], rows,
                                 torch.zeros_like(rows)))
    return psum(parts, devs)


def _head_logits(params, xs, d: int, mesh: Mesh,
                 head_slice: Optional[int]) -> torch.Tensor:
    """The column-split head: each shard's logit columns from its own x,
    concatenated (an all-gather) on the row's first device, then the
    first ``head_slice``."""
    head = params["head"]
    cols = (head["q"] if isinstance(head, dict) else head).shard_shape[-1]
    devs = mesh.devices[d]
    out = []
    for m, x in enumerate(xs):
        lo = m * cols
        want = cols if head_slice is None else min(cols, head_slice - lo)
        if want <= 0:
            break
        hw = rwkv7.head_columns(
            tree_map(lambda s: s.local(d, m), head), want)
        out.append(qmatmul(x, hw).float().to(devs[0]))
    return torch.cat(out, dim=-1)


def step_sharded(params, token: torch.Tensor, state, cfg: RwkvConfig,
                 mesh: Mesh, head_slice: Optional[int] = None):
    """``rwkv7.step`` on ``shard_params``/``shard_state`` trees: token [B]
    (any device) → logits [B, head_slice or V] f32 on ``mesh.home``;
    ``state`` is updated in place. Every shard runs the replicated layer
    stack on its own copy of its row's state."""
    rows = []
    for d, tok in enumerate(split_batch(token, mesh)):
        xs = []
        for m, x in enumerate(_embed_rows(params, tok, d, mesh)):
            p = local_tree({k: v for k, v in params.items()
                            if k not in ("emb", "head")}, d, m)
            st = {k: v.local(d, m) for k, v in state.items()}
            xs.append(rwkv7._step_layers(p, rwkv7._embed(p, x, cfg), st,
                                         cfg))
        rows.append(_head_logits(params, xs, d, mesh, head_slice))
    return gather_batch(rows, mesh), state


@functools.lru_cache(maxsize=16)
def make_step_fn(cfg: RwkvConfig, mesh: Mesh):
    """The decode-step hook of the engine stages for ``shard_params``
    trees, ``step_fn(params, token, state, head_slice)``; the same object
    for the same (cfg, mesh)."""
    def step_fn(params, token, state, head_slice):
        return step_sharded(params, token, state, cfg, mesh,
                            head_slice=head_slice)
    return step_fn

"""An in-process shard mesh: the port's counterpart of a
``jax.sharding.Mesh`` and of the ``shard_map`` collectives the JAX
package's ``parallel`` modules use.

The JAX package runs every distributed operation as one ``shard_map``
program over a mesh of devices driven by one process (the reference's
``GpuPartitioner`` + ``MultiGpuVector``, SURVEY.md §3.6).  The port keeps
the single controller: one process holds every shard's tensors, a sharded
value is the list of its shards' tensors (``Sharded``), local phases run
shard by shard, and the collectives are tensor copies and sums between
the shards.  Shard ``s`` sits on ``devices[s]``; by default a CUDA mesh
puts it on ``cuda:(s mod device_count)``, so one card holds every shard
(each exchange, owner weight and fixed-order sum still runs on the card)
and four cards hold one each (the copies become peer copies).

Collective semantics are JAX's:

- ``ppermute``: a shard that no pair sends to receives zeros;
- ``all_gather``: the group's parts stacked (or, ``tiled``, concatenated)
  along ``dim``, in axis-index order;
- ``all_to_all``: each part split into as many chunks as the axis has
  shards along ``split_dim``; shard i receives chunk i of every part,
  concatenated along ``concat_dim`` in source order;
- ``psum``: the partials summed in fixed shard order on the group's first
  device, and the same bits copied to every shard, so every shard takes
  the same solver branch and two runs are bitwise equal.

A collective result that several shards on one device share is one
tensor; nothing in the port writes into a collective's result in place.

``Sharded`` values support elementwise arithmetic with each other and
with Python numbers, torch functions map over the parts
(``torch.zeros_like``, ``torch.sqrt``, ...; a reduction such as
``torch.dot`` is then shard-local), ``float()`` reads a replicated scalar
from shard 0, and the class is a registered pytree node, so
``torch.func.linearize`` differentiates through a sharded function and
its collectives, as ``jax.linearize`` does through ``ppermute``.
"""

from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np
import torch
import torch.utils._pytree as _pytree


class Sharded:
    """A value split over the shards of a mesh: one tensor a shard."""

    __slots__ = ("parts",)

    def __init__(self, parts: Iterable[torch.Tensor]):
        self.parts = list(parts)

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        n = _count(args, kwargs)
        return Sharded(
            func(*_pick(args, i), **_pick(kwargs, i)) for i in range(n))

    def _zip(self, other, f):
        if isinstance(other, Sharded):
            return Sharded(f(a, b) for a, b in zip(self.parts, other.parts))
        if isinstance(other, torch.Tensor):
            raise TypeError("a Sharded value combines with Sharded values "
                            "and Python numbers, not a bare tensor")
        return Sharded(f(a, other) for a in self.parts)

    def __add__(self, o):
        return self._zip(o, lambda a, b: a + b)

    def __radd__(self, o):
        return self._zip(o, lambda a, b: b + a)

    def __sub__(self, o):
        return self._zip(o, lambda a, b: a - b)

    def __rsub__(self, o):
        return self._zip(o, lambda a, b: b - a)

    def __mul__(self, o):
        return self._zip(o, lambda a, b: a * b)

    def __rmul__(self, o):
        return self._zip(o, lambda a, b: b * a)

    def __truediv__(self, o):
        return self._zip(o, lambda a, b: a / b)

    def __rtruediv__(self, o):
        return self._zip(o, lambda a, b: b / a)

    def __neg__(self):
        return Sharded(-a for a in self.parts)

    def __float__(self) -> float:
        """A replicated scalar (a ``psum`` result), read from shard 0."""
        if self.parts[0].numel() != 1:
            raise TypeError("float() of a Sharded value needs a scalar")
        return float(self.parts[0])

    def __getitem__(self, idx) -> "Sharded":
        return Sharded(a[idx] for a in self.parts)

    def __setitem__(self, idx, value) -> None:
        for i, a in enumerate(self.parts):
            a[idx] = _pick(value, i)

    def to(self, *args, **kwargs) -> "Sharded":
        return Sharded(a.to(*args, **kwargs) for a in self.parts)

    def clamp_min(self, v) -> "Sharded":
        return Sharded(a.clamp_min(v) for a in self.parts)

    def new_tensor(self, data) -> "Sharded":
        """``data`` as a tensor on every shard (one copy a shard)."""
        return Sharded(a.new_tensor(data) for a in self.parts)

    def tolist(self):
        """A replicated value (a ``psum`` result), read from shard 0."""
        return self.parts[0].tolist()

    def element_size(self) -> int:
        return self.parts[0].element_size()

    @property
    def dtype(self) -> torch.dtype:
        return self.parts[0].dtype


def _count(args, kwargs) -> int:
    found: list[int] = []

    def walk(a):
        if isinstance(a, Sharded):
            found.append(len(a.parts))
        elif isinstance(a, (list, tuple)):
            for b in a:
                walk(b)
        elif isinstance(a, dict):
            for b in a.values():
                walk(b)

    walk(args)
    walk(kwargs)
    if len(set(found)) != 1:
        raise ValueError("Sharded arguments with different shard counts")
    return found[0]


def _pick(a, i: int):
    if isinstance(a, Sharded):
        return a.parts[i]
    if isinstance(a, (list, tuple)):
        return type(a)(_pick(b, i) for b in a)
    if isinstance(a, dict):
        return {k: _pick(v, i) for k, v in a.items()}
    return a


_pytree.register_pytree_node(
    Sharded, lambda s: (list(s.parts), None),
    lambda parts, _ctx: Sharded(parts))


def to_host(t):
    """A tensor as host f64 numpy (None stays None; arrays are cast)."""
    if t is None:
        return None
    if isinstance(t, torch.Tensor):
        return t.detach().to("cpu", torch.float64).numpy()
    return np.asarray(t, np.float64)


def smap(f, *args) -> Sharded:
    """``f`` applied shard by shard: ``Sharded`` arguments give their
    part, others pass as they are."""
    return Sharded(f(*_pick(args, i)) for i in range(_count(args, {})))


class ShardMesh:
    """A 1-axis ``(n,)`` or 2-axis ``(sz, sy)`` grid of shards, row-major
    (shard ``s`` at ``divmod(s, sy)`` on a 2-axis mesh), each on a
    device.

    ``devices``: one device a shard; None puts shard ``s`` on
    ``cuda:(s mod torch.cuda.device_count())`` when ``device`` is a CUDA
    device, and every shard on the CPU when it is the CPU."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 devices=None, device: torch.device | str = "cuda"):
        self.shape = tuple(int(n) for n in shape)
        self.axis_names = tuple(axis_names)
        if len(self.shape) not in (1, 2) or len(self.axis_names) != len(
                self.shape):
            raise ValueError("a shard mesh has one or two named axes")
        self.n = int(np.prod(self.shape))
        if devices is None:
            device = torch.device(device)
            if device.type == "cuda":
                if not torch.cuda.is_available():
                    raise RuntimeError(
                        "device 'cuda' requested but torch.cuda is not "
                        "available; pass device='cpu' to run the plain "
                        "PyTorch version on the CPU")
                nd = torch.cuda.device_count()
                devices = [torch.device("cuda", s % nd)
                           for s in range(self.n)]
            else:
                devices = [device] * self.n
        devices = [torch.device(d) for d in devices]
        if len(devices) < self.n:
            raise ValueError(f"need {self.n} devices, have {len(devices)}")
        self.devices = devices[: self.n]

    # ------------------------------------------------------------------
    @property
    def n_devices(self) -> int:
        """The number of distinct devices the shards sit on."""
        return len(set(self.devices))

    def _axis(self, axis) -> int:
        return self.axis_names.index(axis) if isinstance(axis, str) else axis

    def coords(self, s: int) -> tuple[int, ...]:
        return tuple(int(c) for c in np.unravel_index(s, self.shape))

    def shard_at(self, coords: Sequence[int]) -> int:
        return int(np.ravel_multi_index(tuple(coords), self.shape))

    def axis_index(self, axis) -> list[int]:
        """Each shard's index along ``axis``."""
        a = self._axis(axis)
        return [self.coords(s)[a] for s in range(self.n)]

    def groups(self, axes=None) -> list[list[int]]:
        """The shards that share every coordinate off ``axes`` (None: all
        axes), each group in row-major order of ``axes``."""
        ax = (set(range(len(self.shape))) if axes is None else
              {self._axis(a) for a in
               ((axes,) if isinstance(axes, (str, int)) else axes)})
        out: dict = {}
        for s in range(self.n):
            c = self.coords(s)
            key = tuple(v for i, v in enumerate(c) if i not in ax)
            out.setdefault(key, []).append(s)
        return list(out.values())

    # ---- host <-> shards ----------------------------------------------
    def put(self, stacked, dtype: torch.dtype | None = None) -> Sharded:
        """(n_shards, ...) host array (or a list of per-shard arrays) ->
        one tensor a shard on its device (a copy: no shard shares memory
        with the host array or another shard)."""
        return Sharded(
            torch.tensor(np.asarray(stacked[s]), device=self.devices[s],
                         dtype=dtype)
            for s in range(self.n))

    def replicate(self, t: torch.Tensor) -> Sharded:
        """One tensor -> the same value on every shard (one copy a
        device)."""
        copies: dict = {}
        parts = []
        for d in self.devices:
            if d not in copies:
                copies[d] = t.to(d)
            parts.append(copies[d])
        return Sharded(parts)

    @staticmethod
    def stack(x: Sharded) -> np.ndarray:
        """Sharded -> (n_shards, ...) host f64/int array (the JAX
        package's stacked layout)."""
        return np.stack([a.detach().cpu().numpy() if a.dtype not in (
            torch.bfloat16,) else a.detach().float().cpu().numpy()
            for a in x.parts])

    # ---- collectives ----------------------------------------------------
    def ppermute(self, x: Sharded, axis, perm) -> Sharded:
        """Send part (axis index i) to the shard at axis index j for each
        (i, j) in ``perm``; the other shards get zeros."""
        a = self._axis(axis)
        src_of = {int(j): int(i) for i, j in perm}
        out = []
        for s in range(self.n):
            c = list(self.coords(s))
            if c[a] in src_of:
                c[a] = src_of[c[a]]
                out.append(x.parts[self.shard_at(c)].to(self.devices[s]))
            else:
                out.append(torch.zeros_like(x.parts[s]))
        return Sharded(out)

    def _per_group(self, x: Sharded, axes, make) -> Sharded:
        """``make(group parts, device)`` once a (group, device), the
        result on every shard of the group."""
        out: list = [None] * self.n
        for g in self.groups(axes):
            cache: dict = {}
            for s in g:
                d = self.devices[s]
                if d not in cache:
                    cache[d] = make([x.parts[k] for k in g], d)
                out[s] = cache[d]
        return Sharded(out)

    def all_gather(self, x: Sharded, axis, dim: int = 0,
                   tiled: bool = False) -> Sharded:
        def make(parts, d):
            parts = [p.to(d) for p in parts]
            return (torch.cat(parts, dim=dim) if tiled
                    else torch.stack(parts, dim=dim))

        return self._per_group(x, axis, make)

    def all_to_all(self, x: Sharded, axis, split_dim: int = 0,
                   concat_dim: int = 0) -> Sharded:
        a = self._axis(axis)
        ns = self.shape[a]
        out: list = [None] * self.n
        for g in self.groups(axis):
            chunks = [torch.chunk(x.parts[k], ns, dim=split_dim) for k in g]
            for i, s in enumerate(g):
                out[s] = torch.cat(
                    [chunks[j][i].to(self.devices[s]) for j in range(ns)],
                    dim=concat_dim)
        return Sharded(out)

    def psum(self, x: Sharded, axes=None) -> Sharded:
        """Sum over the shards of ``axes`` (None: every axis), in fixed
        shard order on the group's first device; the same bits on every
        shard."""
        def make(parts, d):
            tot = parts[0]
            for p in parts[1:]:
                tot = tot + p.to(tot.device)
            return tot.to(d)

        out: list = [None] * self.n
        for g in self.groups(axes):
            tot = make([x.parts[k] for k in g], self.devices[g[0]])
            cache = {tot.device: tot}
            for s in g:
                d = self.devices[s]
                if d not in cache:
                    cache[d] = tot.to(d)
                out[s] = cache[d]
        return Sharded(out)

    def reduce(self, x: Sharded, device: torch.device | str) -> torch.Tensor:
        """``psum`` over every shard, held once on ``device``: the value a
        replicated computation starts from (the JAX package's psum before
        the identical work of every shard; the port does that work once
        a mesh and ``replicate``s its result)."""
        tot = x.parts[0]
        for p in x.parts[1:]:
            tot = tot + p.to(tot.device)
        return tot.to(device)

"""The port's in-process shard mesh (``tpufem_torch.parallel.mesh``)
against ``jax.lax``'s collectives inside ``jax.shard_map`` on the 8 virtual
CPU devices of tests/conftest.py: ``ppermute`` (cyclic and not: an
unsent shard receives zeros), ``all_gather`` (stacked and tiled),
``all_to_all`` and ``axis_index``, each bit for bit in f64, and ``psum``
over one and both axes of a 2-axis mesh (to 1e-14: XLA's CPU all-reduce
may associate the sum otherwise); the port's ``psum`` gives the same bits
on every shard and from run to run, in fixed shard order; ``Sharded`` arithmetic, torch functions
and ``torch.func.linearize`` through a collective."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh
from jax.sharding import PartitionSpec as P

from tpufem_torch.parallel.mesh import Sharded, ShardMesh, smap


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this module runs: its sharded applies are
    many small torch ops, which a worker sharing the cores with five others
    would otherwise run on eight spinning threads each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RNG = np.random.default_rng(3)


def jax_run(body, x, shape, names):
    """body(x_local) under shard_map over a (shape) mesh of the first
    prod(shape) CPU devices; x stacked (n, ...)."""
    n = int(np.prod(shape))
    mesh = JMesh(np.array(jax.devices()[:n]).reshape(shape), names)
    spec = P(names)
    f = jax.jit(jax.shard_map(lambda a: body(a[0])[None], mesh=mesh,
                              in_specs=spec, out_specs=spec))
    return np.asarray(f(jnp.asarray(x)))


def port_mesh(shape, names):
    return ShardMesh(shape, names, device="cpu")


def sharded(x):
    return Sharded(torch.as_tensor(a) for a in x)


def stacked(y):
    return np.stack([a.numpy() for a in y.parts])


@pytest.mark.parametrize("perm", [
    [(k, (k + 1) % 4) for k in range(4)],
    [(k, k - 1) for k in range(1, 4)],
    [(0, 2), (3, 1)],
], ids=["cyclic", "shift", "partial"])
def test_ppermute_1axis(perm):
    x = RNG.standard_normal((4, 5, 3))
    ref = jax_run(lambda a: jax.lax.ppermute(a, "s", perm), x, (4,), ("s",))
    got = port_mesh((4,), ("s",)).ppermute(sharded(x), "s", perm)
    assert np.array_equal(stacked(got), ref)


@pytest.mark.parametrize("axis", ["z", "y"])
def test_ppermute_2axis(axis):
    x = RNG.standard_normal((8, 6))
    ns = 2 if axis == "z" else 4
    perm = [(k, k + 1) for k in range(ns - 1)]
    ref = jax_run(lambda a: jax.lax.ppermute(a, axis, perm), x, (2, 4),
                  ("z", "y"))
    got = port_mesh((2, 4), ("z", "y")).ppermute(sharded(x), axis, perm)
    assert np.array_equal(stacked(got), ref)


@pytest.mark.parametrize("tiled", [False, True])
@pytest.mark.parametrize("dim", [0, 1])
def test_all_gather(tiled, dim):
    x = RNG.standard_normal((4, 3, 5))
    ref = jax_run(lambda a: jax.lax.all_gather(a, "s", axis=dim,
                                               tiled=tiled),
                  x, (4,), ("s",))
    got = port_mesh((4,), ("s",)).all_gather(sharded(x), "s", dim=dim,
                                              tiled=tiled)
    assert np.array_equal(stacked(got), ref)


def test_all_gather_2axis_along_y():
    x = RNG.standard_normal((8, 3))
    ref = jax_run(lambda a: jax.lax.all_gather(a, "y"), x, (2, 4),
                  ("z", "y"))
    got = port_mesh((2, 4), ("z", "y")).all_gather(sharded(x), "y")
    assert np.array_equal(stacked(got), ref)


@pytest.mark.parametrize("split", [0, 1])
def test_all_to_all(split):
    shape = (4, 6) if split == 0 else (3, 4, 2)
    x = RNG.standard_normal((4,) + shape)
    ref = jax_run(lambda a: jax.lax.all_to_all(a, "s", split, split), x,
                  (4,), ("s",))
    got = port_mesh((4,), ("s",)).all_to_all(sharded(x), "s",
                                              split_dim=split,
                                              concat_dim=split)
    assert np.array_equal(stacked(got), ref)


@pytest.mark.parametrize("axes", [("z", "y"), "z", "y"],
                         ids=["both", "z", "y"])
def test_psum(axes):
    x = RNG.standard_normal((8, 7))
    ref = jax_run(lambda a: jax.lax.psum(a, axes), x, (2, 4), ("z", "y"))
    mesh = port_mesh((2, 4), ("z", "y"))
    got = mesh.psum(sharded(x), None if axes == ("z", "y") else axes)
    # the same sums (JAX's CPU all-reduce may associate differently)
    assert np.allclose(stacked(got), ref, rtol=1e-14, atol=1e-14)


def test_psum_same_bits_everywhere_and_every_run():
    mesh = port_mesh((8,), ("s",))
    x = sharded(RNG.standard_normal((8, 1000)) * 10.0 ** RNG.integers(
        -8, 8, (8, 1000)))
    a, b = mesh.psum(x), mesh.psum(x)
    for part in a.parts + b.parts:
        assert torch.equal(part, a.parts[0])
    # fixed shard order: ((x0 + x1) + x2) + ...
    tot = x.parts[0]
    for part in x.parts[1:]:
        tot = tot + part
    assert torch.equal(a.parts[0], tot)
    assert torch.equal(mesh.reduce(x, "cpu"), tot)


def test_axis_index():
    mesh = port_mesh((2, 4), ("z", "y"))
    for ax in ("z", "y"):
        ref = jax_run(lambda a: a + jax.lax.axis_index(ax), np.zeros((8, 1)),
                      (2, 4), ("z", "y"))
        assert mesh.axis_index(ax) == [int(v) for v in ref[:, 0]]


def test_sharded_values():
    x = sharded(RNG.standard_normal((3, 4)))
    y = sharded(RNG.standard_normal((3, 4)))
    z = 2.0 * x - y / 3.0 + 1.0
    for a, b, c in zip(x.parts, y.parts, z.parts):
        assert torch.equal(c, 2.0 * a - b / 3.0 + 1.0)
    zz = torch.zeros_like(x)
    assert isinstance(zz, Sharded) and all(float(p.abs().sum()) == 0
                                           for p in zz.parts)
    d = smap(torch.dot, x, y)
    assert float(d) == float(torch.dot(x.parts[0], y.parts[0]))
    with pytest.raises(TypeError):
        x + torch.ones(4)
    assert x.element_size() == 8 and x.dtype == torch.float64


def test_linearize_through_a_collective():
    """torch.func.linearize of a sharded function with a psum and a
    ppermute: its JVP equals the central difference."""
    mesh = port_mesh((4,), ("s",))

    def f(u: Sharded) -> Sharded:
        s = mesh.psum(smap(lambda a: torch.dot(a, a), u))
        nb = mesh.ppermute(u, "s", [(k, (k + 1) % 4) for k in range(4)])
        return u * u * s + nb

    u = sharded(RNG.standard_normal((4, 6)))
    t = sharded(RNG.standard_normal((4, 6)))
    _, jvp = torch.func.linearize(f, u)
    h = 1e-6
    fd = (f(u + h * t) - f(u - h * t)) / (2 * h)
    got = jvp(t)
    for a, b in zip(got.parts, fd.parts):
        assert torch.allclose(a, b, rtol=1e-7, atol=1e-7)


def test_mesh_devices_and_refusals():
    m = port_mesh((2, 2), ("z", "y"))
    assert m.devices == [torch.device("cpu")] * 4 and m.n_devices == 1
    assert m.groups("y") == [[0, 1], [2, 3]]
    assert m.groups("z") == [[0, 2], [1, 3]]
    with pytest.raises(ValueError):
        ShardMesh((2, 2, 2), ("a", "b", "c"), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            ShardMesh((2,), ("s",))

"""The hash lookup's coords form (kernels/hash_probe.py's lookup; on the card
csrc/hash_probe.cu's hash_lookup_kernel) against the JAX reference, and its
kernel against its plain version.

On the CPU:
  * the arguments the wrapper hands the C entry point;
  * the port's HashTable.lookup held to immesh_tpu.map.hash.HashTable.lookup
    on numpy-seeded tables at the three shapes its callers probe, cut down:
    the plane map's stacked level keys (4 levels × 2 probes × 512 points =
    4,096 keys into 2^14 slots), a refinement level's parent keys (1,024
    into 2^14) and a mesh voxel table's neighbourhoods (64 voxels × 27 =
    1,728 into 2^12), from aligned rows and from a misaligned view, at
    max_probe 32 and 1.  Tolerance: the slots are EQUAL (integer
    arithmetic and comparisons only).

The `cuda` tests hold the kernel to lookup_plain bit for bit on the card at
the callers' full shapes (65,536 and 8,192 keys into 2^18 slots, 27,648
into 2^15), from a misaligned view, at max_probe 0 and 1, for n = 1, and
inside a captured CUDA graph; they skip without a card.  The reference is
imported inside a fixture, so on the GPU machine (no JAX)

    python -m pytest --noconftest -m cuda tests/test_torch_lookup_coords.py
"""

import numpy as np
import pytest
import torch

from immesh_tpu_torch.kernels import hash_probe as hp
from immesh_tpu_torch.map.hash import HashTable

# (keys, capacity) of each caller's shape, cut down for the CPU, and full
_SHAPES = {"planes": (4096, 2 ** 14), "parent": (1024, 2 ** 14),
           "neighbors": (1728, 2 ** 12)}
_CARD_SHAPES = {"planes": (65536, 2 ** 18), "parent": (8192, 2 ** 18),
                "neighbors": (27648, 2 ** 15)}


@pytest.fixture(scope="module")
def jhash():
    """The reference's hash module (JAX on the CPU, as conftest sets it)."""
    from immesh_tpu.map import hash as jhash
    return jhash


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda")


def _keys(kind: str, n: int, seed: int) -> np.ndarray:
    """(n, 4) int32 keys as each caller makes them: the planes form's voxel
    keys of points and of their near shifts at 4 levels of a 3 m voxel
    (L·P·N rows, level-major), the parent form's keys of points at one
    level, the neighbours form's 3×3×3 neighbourhoods (4th column 0) of
    voxel keys."""
    rng = np.random.default_rng(seed)
    if kind == "neighbors":
        a = n // 27
        vox = rng.integers(-30, 30, (a, 3))
        offs = np.stack(np.meshgrid(*[np.arange(-1, 2)] * 3, indexing="ij"),
                        -1).reshape(27, 3)
        nb = (vox[:, None] + offs[None]).reshape(a * 27, 3)
        return np.concatenate([nb, np.zeros((a * 27, 1), np.int64)],
                              1).astype(np.int32)
    if kind == "parent":
        p = rng.normal(0, 30, (n, 3))
        return np.concatenate([np.floor(p / 1.5), np.full((n, 1), 1)],
                              1).astype(np.int32)
    p = rng.normal(0, 30, (n // 8, 3))
    probes = np.concatenate([p, p + rng.choice([-3.0, 0.0, 3.0], p.shape)])
    return np.concatenate([
        np.concatenate([np.floor(probes / (3.0 / 2 ** lvl)),
                        np.full((len(probes), 1), lvl)], 1)
        for lvl in range(4)]).astype(np.int32)


def _table_keys(kind: str, queries: np.ndarray, cap: int,
                seed: int) -> np.ndarray:
    """Unique keys to insert: 70 % of the queries' distinct keys and random
    others, to about half the capacity."""
    rng = np.random.default_rng(seed + 1)
    uniq = np.unique(queries, axis=0)
    keep = uniq[rng.random(len(uniq)) < 0.7]
    fill = rng.integers(100, 10 ** 6, (cap // 2, 4)).astype(np.int32)
    fill[:, 3] = 0 if kind == "neighbors" else fill[:, 3] % 4
    both = np.unique(np.concatenate([keep, fill]), axis=0)
    return both[rng.permutation(len(both))[:cap // 2]]


def _misaligned(rows: torch.Tensor) -> torch.Tensor:
    """The same rows in a contiguous (n, 4) view of a flat buffer from its
    second element: no row starts 16-byte aligned."""
    flat = torch.empty(rows.numel() + 1, dtype=rows.dtype, device=rows.device)
    view = flat[1:].view(-1, 4)
    view.copy_(rows)
    return view


# ---------------------------------------------------------------------------
# the wrapper's launch
# ---------------------------------------------------------------------------
def test_launch_arguments_follow_the_key_rows(monkeypatch):
    """_launch_lookup hands the C entry point the rows as given (aligned or
    not), the key count, the capacity, max_probe and the slot buffer."""
    seen = []
    monkeypatch.setattr(hp, "_stream_launch",
                        lambda device, name, fn, *args: seen.append(
                            (name, fn, args)))
    lib = type("Lib", (), {"hash_lookup_launch": object()})()
    n = 27648
    fp = torch.zeros(2 ** 12, dtype=torch.int32)
    rows = torch.zeros((n, 4), dtype=torch.int32)
    slot = torch.empty(n, dtype=torch.int32)
    for coords in (rows, _misaligned(rows)):
        hp._launch_lookup(lib, coords, fp, 7, slot)
        name, fn, args = seen.pop()
        assert name == "hash_lookup" and fn is lib.hash_lookup_launch
        assert args == (coords.data_ptr(), fp.data_ptr(), n, 2 ** 12, 7,
                        slot.data_ptr())


# ---------------------------------------------------------------------------
# the port's HashTable.lookup against the reference's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", sorted(_SHAPES))
def test_lookup_equals_the_reference_at_the_callers_shapes(jhash, kind):
    import jax.numpy as jnp

    n, cap = _SHAPES[kind]
    queries = _keys(kind, n, seed=30)
    assert queries.shape == (n, 4)
    ins = _table_keys(kind, queries, cap, seed=30)
    jt = jhash.HashTable.create(cap, 32)
    jt, js = jt.insert(jnp.asarray(ins), jnp.ones(len(ins), bool))
    table = HashTable.create(cap, 32, device="cpu")
    ts, _ = table.insert(torch.from_numpy(ins),
                         torch.ones(len(ins), dtype=torch.bool))
    np.testing.assert_array_equal(np.asarray(js), ts.numpy())
    np.testing.assert_array_equal(np.asarray(jt.fp), table.fp.numpy())
    rows = torch.from_numpy(queries)
    odd = _misaligned(rows)
    assert odd.data_ptr() % 16 != 0 and torch.equal(odd, rows)
    found = 0
    for mp in (32, 1):
        want = np.asarray(jt.replace(max_probe=mp).lookup(
            jnp.asarray(queries)))
        t = HashTable(table.keys, table.fp, cap, mp)
        for view in (rows, odd):
            np.testing.assert_array_equal(want, t.lookup(view).numpy())
        found = max(found, int((want >= 0).sum()))
    assert 0 < found < n  # present and absent keys both


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
def _card_case(kind, dev):
    n, cap = _CARD_SHAPES[kind]
    queries = _keys(kind, n, seed=40)
    table = HashTable.create(cap, 32, device=dev)
    ins = torch.from_numpy(_table_keys(kind, queries, cap // 8, seed=40))
    table.insert(ins.to(dev), torch.ones(len(ins), dtype=torch.bool,
                                         device=dev))
    return torch.from_numpy(queries).to(dev), table


@pytest.mark.cuda
@pytest.mark.parametrize("kind", sorted(_CARD_SHAPES))
def test_kernel_equals_the_plain_version_on_the_card(dev, kind):
    q, table = _card_case(kind, dev)
    odd = _misaligned(q)
    for mp in (32, 4, 1, 0):
        want = hp.lookup_plain(q, table.fp, mp)
        assert torch.equal(hp.lookup_cuda(q, table.fp, mp), want)
        assert torch.equal(hp.lookup_cuda(odd, table.fp, mp), want)
    assert torch.equal(hp.lookup_cuda(q[:1], table.fp, 32),
                       hp.lookup_plain(q[:1], table.fp, 32))
    assert torch.equal(hp.lookup_cuda(odd[:1], table.fp, 32),
                       hp.lookup_plain(q[:1], table.fp, 32))


@pytest.mark.cuda
def test_kernel_replays_in_a_captured_graph(dev):
    """Lookups captured back to back (each a programmatic dependent of the
    one before), replayed after their outputs were overwritten: each
    equals the plain version."""
    q, table = _card_case("neighbors", dev)
    odd = _misaligned(q)
    s = torch.cuda.Stream(dev)
    s.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(s):
        hp.lookup_cuda(q, table.fp, 32)
    torch.cuda.current_stream(dev).wait_stream(s)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=s):
        outs = [hp.lookup_cuda(q, table.fp, 32),
                hp.lookup_cuda(odd, table.fp, 1),
                hp.lookup_cuda(q, table.fp, 32)]
    for o in outs:
        o.fill_(-7)
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(outs[0], hp.lookup_plain(q, table.fp, 32))
    assert torch.equal(outs[1], hp.lookup_plain(q, table.fp, 1))
    assert torch.equal(outs[2], outs[0])

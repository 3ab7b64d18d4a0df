"""The hash table's probe loops (kernels/hash_probe.py) against the JAX
reference, and their CUDA kernels against the plain versions.

On the CPU, `lookup_plain` and `insert_plain` are held to
immesh_tpu.map.hash.HashTable on the same seeded numpy keys: slots, `new`,
keys and fp must be EQUAL (integer arithmetic and comparisons only) at high
load, at max_probe 1, 4 and 32 with exhaustion, in a table so small that
lanes collide on one slot, with invalid lanes, and with a planted
fingerprint collision that the lookup must alias as the reference does.
The insert kernel's schedule (the claim tournament run on fp, each winner's
fingerprint written one round later) is emulated phase by phase and held
to the plain version too.  A CPU table never loads the CUDA library, and a
tensor that is not on the CPU never takes the plain loop.

The `cuda` tests compare each kernel with its plain version on the card and
show that a failed build or launch raises; they skip without a card.  The
reference is imported inside a fixture, so on the GPU machine (no JAX)

    python -m pytest --noconftest -m cuda tests/test_torch_hash_kernels.py
"""

import numpy as np
import pytest
import torch

from immesh_tpu_torch.kernels import build
from immesh_tpu_torch.kernels import hash_probe as hp
from immesh_tpu_torch.map.hash import HashTable

_M32 = 2 ** 32
# _fingerprint's Weyl constants, as unsigned 32-bit words
_WEYL = [x % _M32 for x in (-1640531527, -1274297907, -1981354251,
                            1183186591)]


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


def _unique_keys(rng, n, span=40):
    keys = set()
    while len(keys) < n:
        keys.add(tuple(int(x) for x in rng.integers(-span, span, 3))
                 + (int(rng.integers(0, 3)),))
    return np.array(sorted(keys), np.int32)[rng.permutation(n)]


def _colliding_pair(rng):
    """Two distinct keys with one fingerprint: k2 differs from k1 in its
    second coordinate by the inverse of that coordinate's Weyl constant, so
    the fingerprint's sum rises by exactly 1 from an even value, which `| 1`
    erases."""
    inv = pow(_WEYL[1], -1, _M32)
    while True:
        k1 = rng.integers(-1000, 1000, 4).astype(np.int64)
        if sum(int(c) % _M32 * w for c, w in zip(k1, _WEYL)) % _M32 % 2 == 0:
            break
    k2 = k1.copy()
    k2[1] = (int(k1[1]) + inv) % _M32
    return (np.array(k1, np.int64).astype(np.int32),
            np.array(k2 - (k2 >= 2 ** 31) * _M32, np.int64).astype(np.int32))


def _batches(rng, keys, n_batches, p_valid=0.9):
    """Overlapping batches of unique keys (later batches repeat part of the
    earlier ones, so lanes also find keys already present)."""
    n = len(keys)
    out = []
    for b in range(n_batches):
        lo = max(0, b * n // n_batches - n // (2 * n_batches))
        hi = (b + 1) * n // n_batches
        batch = keys[lo:hi]
        out.append((batch, rng.random(len(batch)) < p_valid))
    return out


def _run_both(jhash, capacity, max_probe, batches, queries):
    """Insert every batch into a reference table and a port table on the
    CPU, comparing after each; then look the queries up in both.  Returns
    the port table, the lookup's slots and whether a valid lane exhausted
    its probe sequence."""
    import jax.numpy as jnp

    jt = jhash.HashTable.create(capacity, max_probe)
    keys = torch.full((capacity, 4), hp.EMPTY, dtype=torch.int32)
    fp = torch.zeros(capacity, dtype=torch.int32)
    exhausted = False
    for coords, valid in batches:
        old_empty = np.asarray(jt.keys[:, 0] == jhash.EMPTY)
        jt, js = jt.insert(jnp.asarray(coords), jnp.asarray(valid))
        ts, new = hp.insert_plain(torch.from_numpy(coords),
                                  torch.from_numpy(valid), keys, fp,
                                  max_probe)
        js = np.asarray(js)
        np.testing.assert_array_equal(js, ts.numpy(), "slots")
        np.testing.assert_array_equal(np.asarray(jt.keys), keys.numpy(),
                                      "keys")
        np.testing.assert_array_equal(np.asarray(jt.fp), fp.numpy(), "fp")
        want_new = (js >= 0) & old_empty[np.maximum(js, 0)]
        np.testing.assert_array_equal(want_new, new.numpy(), "new")
        exhausted |= bool((valid & (js < 0)).any())
    jl = np.asarray(jt.lookup(jnp.asarray(queries)))
    tl = hp.lookup_plain(torch.from_numpy(queries), fp, max_probe)
    np.testing.assert_array_equal(jl, tl.numpy(), "lookup slots")
    return keys, fp, tl, exhausted


# ---------------------------------------------------------------------------
# the plain versions against the reference
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("max_probe", [1, 4, 32])
def test_plain_probe_loops_equal_the_reference_at_high_load(jhash, max_probe):
    """Overlapping batches fill a 512-slot table to ~85 %; at max_probe 1
    and 4 lanes exhaust their probe sequence and both sides report −1."""
    rng = np.random.default_rng(max_probe)
    keys = _unique_keys(rng, 470)
    queries = np.concatenate([keys, _unique_keys(rng, 64, span=60)])
    _, fp, _, exhausted = _run_both(jhash, 512, max_probe,
                                    _batches(rng, keys, 4), queries)
    assert float((fp != 0).float().mean()) > (0.8 if max_probe == 32 else 0.3)
    assert exhausted or max_probe == 32


def test_plain_probe_loops_equal_the_reference_in_a_tiny_table(jhash):
    """12 keys into 8 slots: round 0 has several lanes on one slot (the
    lowest lane wins), and the last keys find no slot at all."""
    rng = np.random.default_rng(5)
    keys = _unique_keys(rng, 12, span=4)
    mask = 7
    h0 = hp._hash(torch.from_numpy(keys), mask).numpy()
    assert len(set(h0.tolist())) < len(h0)          # same-slot claims
    valid = np.ones(12, bool)
    _, fp, slots, exhausted = _run_both(jhash, 8, 32, [(keys, valid)], keys)
    assert bool((fp != 0).all()) and exhausted      # the table is full
    assert int((slots >= 0).sum()) == 8


def test_plain_probe_loops_equal_the_reference_with_invalid_lanes(jhash):
    """Half the lanes invalid, some of them repeating a valid lane's key or
    holding the EMPTY sentinel: they take no slot and change nothing."""
    rng = np.random.default_rng(6)
    keys = _unique_keys(rng, 200)
    coords = np.concatenate([keys, keys[:50],
                             np.full((10, 4), hp.EMPTY, np.int32)])
    valid = np.concatenate([rng.random(200) < 0.5, np.zeros(60, bool)])
    _, fp, slots, _ = _run_both(jhash, 256, 32, [(coords, valid)], keys)
    assert int((fp != 0).sum()) == int(valid.sum())
    assert bool((slots[~valid[:200]] == -1).all())


def test_plain_lookup_aliases_a_planted_fingerprint_collision(jhash):
    """k2 shares k1's fingerprint but not its key.  With k1 on k2's probe
    chain before any empty slot, the lookup of k2 (never inserted) returns
    k1's slot in the reference and in the port: fingerprints only."""
    rng = np.random.default_rng(7)
    for _ in range(64):
        k1, k2 = _colliding_pair(rng)
        assert not np.array_equal(k1, k2)
        f1, f2 = hp._fingerprint(torch.from_numpy(np.stack([k1, k2])))
        assert int(f1) == int(f2)
        others = _unique_keys(rng, 14, span=1000)
        coords = np.concatenate([k1[None], others])
        queries = np.stack([k1, k2])
        _, _, slots, _ = _run_both(jhash, 16, 32,
                                [(coords, np.ones(15, bool))], queries)
        if int(slots[1]) >= 0:
            assert int(slots[1]) == int(slots[0])
            # inserting k2 compares full keys: it takes a slot of its own
            _run_both(jhash, 16, 32, [(coords, np.ones(15, bool)),
                                      (np.stack([k2]), np.ones(1, bool))],
                      queries)
            return
    raise AssertionError("no seed put k1 on k2's chain before an empty slot")


# ---------------------------------------------------------------------------
# the kernels' schedules, emulated on the CPU
# ---------------------------------------------------------------------------
def _insert_as_the_kernel_runs(coords, valid, keys, fp, max_probe):
    """csrc/hash_probe.cu's hash_insert_kernel, phase by phase: the claim is
    an atomicMin of INT_MIN + lane on fp itself, the winner writes its key
    in phase B and its fingerprint in the next round's phase A (or after
    the loop), and the loop ends when a round leaves no lane open."""
    OPEN, ATTEMPT, DONE, PENDING, WON = range(5)
    u = coords.shape[0]
    mask = fp.shape[0] - 1
    h0 = hp._hash(coords, mask)
    fpq = hp._fingerprint(coords)
    claim_of = torch.iinfo(torch.int32).min + torch.arange(u,
                                                          dtype=torch.int32)
    state = torch.where(valid, OPEN, DONE)
    slot = torch.full((u,), -1, dtype=torch.int32)
    for r in range(max_probe):
        # (A)
        pend = state == PENDING
        fp[slot[pend].long()] = fpq[pend]
        state[pend] = WON
        cand = (h0 + r * fpq) & mask
        row = keys[cand.long()]
        is_open = state == OPEN
        match = is_open & (row == coords).all(-1)
        slot = torch.where(match, cand, slot)
        state[match] = DONE
        att = is_open & ~match & (row[:, 0] == hp.EMPTY)
        fp.scatter_reduce_(0, cand[att].long(), claim_of[att], reduce="amin")
        state[att] = ATTEMPT
        # (B)
        att = state == ATTEMPT
        won = att & (fp[cand.long()] == claim_of)
        keys[cand[won].long()] = coords[won]
        slot = torch.where(won, cand, slot)
        state[won] = PENDING
        state[att & ~won] = OPEN
        if not bool((state == OPEN).any()):
            break
    pend = state == PENDING
    fp[slot[pend].long()] = fpq[pend]
    return slot, (state == PENDING) | (state == WON)


@pytest.mark.parametrize("capacity,n_keys,max_probe",
                         [(512, 470, 32), (512, 470, 4), (8, 12, 32),
                          (256, 300, 1)])
def test_insert_kernel_schedule_gives_the_plain_result(capacity, n_keys,
                                                       max_probe):
    rng = np.random.default_rng(capacity + max_probe)
    keys = _unique_keys(rng, n_keys, span=40 if capacity > 8 else 4)
    ref = (torch.full((capacity, 4), hp.EMPTY, dtype=torch.int32),
           torch.zeros(capacity, dtype=torch.int32))
    emu = tuple(x.clone() for x in ref)
    for coords, valid in _batches(rng, keys, 3):
        c, v = torch.from_numpy(coords), torch.from_numpy(valid)
        ps, pn = hp.insert_plain(c, v, *ref, max_probe)
        es, en = _insert_as_the_kernel_runs(c, v, *emu, max_probe)
        assert torch.equal(ps, es) and torch.equal(pn, en)
        assert torch.equal(ref[0], emu[0]) and torch.equal(ref[1], emu[1])


def test_lookup_kernel_schedule_gives_the_plain_result():
    """Each lane's own chain, as the coords kernel runs it (its home slot's
    load, then finish_chain's rounds; max_probe 0 gives -1 with no load),
    stopped at its first match or empty slot or at max_probe, is the
    batched loop's result lane by lane."""
    rng = np.random.default_rng(8)
    keys = torch.from_numpy(_unique_keys(rng, 400))
    table = HashTable.create(512, 32, device="cpu")
    table.insert(keys[:350], torch.ones(350, dtype=torch.bool))
    mask = 511
    words = table.fp.long() % _M32
    for max_probe in (32, 1, 0):
        want = hp.lookup_plain(keys, table.fp, max_probe)
        for i in range(keys.shape[0]):
            h0 = int(hp._hash(keys[i], mask)) % _M32
            fq = int(hp._fingerprint(keys[i])) % _M32
            got, r, cand = -1, 0, h0
            f = int(words[cand]) if max_probe > 0 else None
            while f is not None:  # finish_chain
                if f == fq:
                    got = cand
                    break
                r += 1
                if f == 0 or r >= max_probe:
                    break
                cand = (h0 + r * fq) % _M32 & mask
                f = int(words[cand])
            assert got == int(want[i])


# ---------------------------------------------------------------------------
# dispatch: the CPU never loads the library, nothing else takes the loop
# ---------------------------------------------------------------------------
def test_a_cpu_table_never_loads_the_cuda_library(monkeypatch):
    def no_build(name):
        raise AssertionError(f"the CPU path loaded lib{name}")

    monkeypatch.setattr(build, "load", no_build)
    monkeypatch.setattr(hp, "_lib", None)
    rng = np.random.default_rng(9)
    keys = torch.from_numpy(_unique_keys(rng, 100))
    table = HashTable.create(256, 32, device="cpu")
    slots, new = table.insert(keys, torch.ones(100, dtype=torch.bool))
    assert bool(new.all()) and bool((table.lookup(keys) == slots).all())
    assert hp.launches == dict.fromkeys(hp.KERNELS, 0)
    assert hp.runs() == hp.captured == hp.launches


def test_a_tensor_off_the_cpu_never_takes_the_plain_loop(monkeypatch):
    def plain(*args):
        raise AssertionError("the plain loop ran on a tensor off the CPU")

    monkeypatch.setattr(hp, "lookup_plain", plain)
    monkeypatch.setattr(hp, "insert_plain", plain)
    meta = dict(device="meta", dtype=torch.int32)
    coords, fp = torch.empty((4, 4), **meta), torch.empty(16, **meta)
    with pytest.raises(ValueError, match="CUDA device"):
        hp.lookup(coords, fp, 32)
    with pytest.raises(ValueError, match="CUDA device"):
        hp.insert(coords, torch.empty(4, device="meta", dtype=torch.bool),
                  torch.empty((16, 4), **meta), fp, 32)


def test_insert_path_follows_the_lane_count():
    """The cluster form up to CLUSTER_MAX_LANES (every per-frame insert:
    1,024 LIO lanes, the mesh dedup's 10,000), the cooperative grid
    above (a compaction's 131,072)."""
    assert hp.CLUSTER_MAX_LANES == 8 * 1024 * 2
    for u in (0, 1, 1024, 2048, 2049, 10000, hp.CLUSTER_MAX_LANES):
        assert hp.insert_path(u) == "cluster"
    for u in (hp.CLUSTER_MAX_LANES + 1, 131072):
        assert hp.insert_path(u) == "grid"


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
def _card_cases():
    """(capacity, max_probe, batches, queries) with numpy inputs: the plane
    map's 2^18 slots at ~10 % load and a dense 2^12 table, max_probe 1, 4
    and 32, a tiny table, invalid lanes."""
    rng = np.random.default_rng(10)
    big = _unique_keys(rng, 30000, span=200)
    dense = _unique_keys(rng, 3600, span=60)
    tiny = _unique_keys(rng, 12, span=4)
    qs = _unique_keys(rng, 4096, span=220)
    return [(2 ** 18, 32, _batches(rng, big, 3), np.concatenate([big, qs])),
            (2 ** 12, 32, _batches(rng, dense, 3, 0.7),
             np.concatenate([dense, qs])),
            (2 ** 12, 4, _batches(rng, dense, 3), dense),
            (2 ** 12, 1, _batches(rng, dense, 2), dense),
            (8, 32, [(tiny, np.ones(12, bool))], tiny)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(5))
def test_kernels_equal_the_plain_versions_on_the_card(dev, case):
    capacity, max_probe, batches, queries = _card_cases()[case]
    tk = HashTable.create(capacity, max_probe, device=dev)
    tp = tk.clone()
    hp.reset_launches()
    for coords, valid in batches:
        c, v = torch.from_numpy(coords).to(dev), torch.from_numpy(valid).to(dev)
        ks, kn = hp.insert_cuda(c, v, tk.keys, tk.fp, max_probe)
        ps, pn = hp.insert_plain(c, v, tp.keys, tp.fp, max_probe)
        torch.cuda.synchronize()
        assert torch.equal(ks, ps) and torch.equal(kn, pn)
        assert torch.equal(tk.keys, tp.keys) and torch.equal(tk.fp, tp.fp)
    q = torch.from_numpy(queries).to(dev)
    assert torch.equal(hp.lookup_cuda(q, tk.fp, max_probe),
                       hp.lookup_plain(q, tp.fp, max_probe))
    assert hp.launches == {**dict.fromkeys(hp.KERNELS, 0), "hash_lookup": 1,
                           "hash_insert": len(batches)}
    assert hp.runs() == hp.launches  # the kernels' own device counters


@pytest.mark.cuda
def test_insert_kernel_strides_past_the_resident_threads(dev):
    """More lanes than the card holds threads: each thread of the
    cooperative grid owns several lanes across the grid barriers."""
    props = torch.cuda.get_device_properties(dev)
    resident = props.multi_processor_count * props.max_threads_per_multi_processor
    u = resident + resident // 8
    capacity = 1 << (int(u / 0.3) - 1).bit_length()
    rng = np.random.default_rng(12)
    raw = rng.integers(-2 ** 20, 2 ** 20, (u + u // 8, 4)).astype(np.int32)
    raw[:, 3] &= 3
    keys = np.unique(raw, axis=0)[rng.permutation(u)]
    valid = rng.random(u) < 0.9
    tk = HashTable.create(capacity, 32, device=dev)
    tp = tk.clone()
    for lo, hi in ((0, 3 * u // 4), (u // 2, u)):
        c = torch.from_numpy(keys[lo:hi]).to(dev)
        v = torch.from_numpy(valid[lo:hi]).to(dev)
        ks, kn = hp.insert_cuda(c, v, tk.keys, tk.fp, 32)
        ps, pn = hp.insert_plain(c, v, tp.keys, tp.fp, 32)
        torch.cuda.synchronize()
        assert torch.equal(ks, ps) and torch.equal(kn, pn)
        assert torch.equal(tk.keys, tp.keys) and torch.equal(tk.fp, tp.fp)
    q = torch.from_numpy(keys).to(dev)
    assert torch.equal(hp.lookup_cuda(q, tk.fp, 32),
                       hp.lookup_plain(q, tp.fp, 32))


@pytest.mark.cuda
def test_lookup_kernel_aliases_a_planted_fingerprint_collision(dev):
    rng = np.random.default_rng(7)
    for _ in range(64):
        k1, k2 = _colliding_pair(rng)
        coords = torch.from_numpy(
            np.concatenate([k1[None], _unique_keys(rng, 14, span=1000)]))
        table = HashTable.create(16, 32, device=dev)
        table.insert(coords.to(dev), torch.ones(15, dtype=torch.bool,
                                                device=dev))
        q = torch.from_numpy(np.stack([k1, k2])).to(dev)
        got = hp.lookup_cuda(q, table.fp, 32)
        assert torch.equal(got, hp.lookup_plain(q, table.fp, 32))
        if int(got[1]) >= 0:
            assert int(got[1]) == int(got[0])
            return
    raise AssertionError("no seed put k1 on k2's chain before an empty slot")


@pytest.mark.cuda
def test_a_failed_build_or_launch_raises(dev, monkeypatch):
    coords = torch.zeros((4, 4), dtype=torch.int32, device=dev)
    table = HashTable.create(16, 32, device=dev)

    def broken(name):
        raise RuntimeError(f"building lib{name} failed")

    monkeypatch.setattr(hp, "_lib", None)
    monkeypatch.setattr(build, "load", broken)
    with pytest.raises(RuntimeError, match="building"):
        table.lookup(coords)
    with pytest.raises(RuntimeError, match="building"):
        table.insert(coords, torch.ones(4, dtype=torch.bool, device=dev))

    class Refused:  # a library whose launches report a CUDA error
        def hash_lookup_launch(self, *args):
            return 98

        hash_insert_launch = hash_lookup_launch

    monkeypatch.setattr(hp, "_lib", Refused())
    with pytest.raises(RuntimeError, match="CUDA error 98"):
        table.lookup(coords)
    with pytest.raises(RuntimeError, match="CUDA error 98"):
        table.insert(coords, torch.ones(4, dtype=torch.bool, device=dev))


@pytest.mark.cuda
def test_kernel_wrappers_reject_bad_inputs(dev):
    fp = torch.zeros(16, dtype=torch.int32, device=dev)
    keys = torch.full((16, 4), hp.EMPTY, dtype=torch.int32, device=dev)
    ok = torch.ones(4, dtype=torch.bool, device=dev)
    c = torch.zeros((4, 4), dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        hp.lookup_cuda(c.long(), fp, 32)
    with pytest.raises(ValueError, match="contiguous"):
        hp.lookup_cuda(torch.zeros((4, 8), dtype=torch.int32,
                                   device=dev)[:, ::2], fp, 32)
    with pytest.raises(ValueError, match="power of two"):
        hp.lookup_cuda(c, fp[:12], 32)
    with pytest.raises(TypeError):
        hp.insert_cuda(c, ok.int(), keys, fp, 32)
    with pytest.raises(ValueError, match="CUDA device"):
        hp.insert_cuda(c, ok.cpu(), keys, fp, 32)


# (lanes, path): the one-block form's edges, the cluster's (2, 4 and 8
# blocks), the threshold and one past it, a compaction's rebuild; the
# cooperative grid at the path's shapes too
_PATH_CASES = [(1, "cluster"), (1024, "cluster"), (1024, "grid"),
               (2048, "cluster"), (2049, "cluster"), (5000, "cluster"),
               (10000, "cluster"), (10000, "grid"), (16384, "cluster"),
               (16384, "grid"), (16385, "grid"), (131072, "grid")]


@pytest.mark.cuda
@pytest.mark.parametrize("u,path", _PATH_CASES)
def test_insert_paths_equal_the_plain_version_on_the_card(dev, u, path):
    """Two overlapping batches of u lanes (10 % invalid) into a table at
    ~30 % load after them, at max_probe 32 and 1 (lanes exhaust): slots,
    new, keys and fp bit for bit on either form."""
    rng = np.random.default_rng(u)
    capacity = 1 << (int(1.5 * u / 0.3) - 1).bit_length()
    raw = rng.integers(-2 ** 20, 2 ** 20, (2 * u + 64, 4)).astype(np.int32)
    raw[:, 3] &= 3
    keys = np.unique(raw, axis=0)[rng.permutation(3 * u // 2)]
    valid = rng.random(3 * u // 2) < 0.9
    for max_probe in (32, 1):
        tk = HashTable.create(capacity, max_probe, device=dev)
        tp = tk.clone()
        for lo in (0, u // 2):
            c = torch.from_numpy(keys[lo:lo + u]).to(dev)
            v = torch.from_numpy(valid[lo:lo + u]).to(dev)
            ks, kn = hp.insert_cuda(c, v, tk.keys, tk.fp, max_probe, path)
            ps, pn = hp.insert_plain(c, v, tp.keys, tp.fp, max_probe)
            torch.cuda.synchronize()
            assert torch.equal(ks, ps) and torch.equal(kn, pn)
            assert torch.equal(tk.keys, tp.keys) and torch.equal(tk.fp, tp.fp)
        if max_probe == 1 and u > 64:
            assert bool((v & (ps < 0)).any())  # some lane exhausted


@pytest.mark.cuda
def test_insert_takes_its_form_from_the_lane_count(dev, monkeypatch):
    """insert_cuda's form is insert_path's; the cluster form refuses more
    than CLUSTER_MAX_LANES and raises."""
    paths = []
    launch = hp._launch_insert

    def spy(*args):
        paths.append(args[-1])
        return launch(*args)

    monkeypatch.setattr(hp, "_launch_insert", spy)
    for u in (1024, hp.CLUSTER_MAX_LANES, hp.CLUSTER_MAX_LANES + 1):
        table = HashTable.create(1 << 17, 32, device=dev)
        c = torch.arange(4 * u, dtype=torch.int32, device=dev).reshape(u, 4)
        table.insert(c, torch.ones(u, dtype=torch.bool, device=dev))
    assert paths == ["cluster", "cluster", "grid"]
    u = hp.CLUSTER_MAX_LANES + 1
    c = torch.arange(4 * u, dtype=torch.int32, device=dev).reshape(u, 4)
    with pytest.raises(RuntimeError, match="launch failed"):
        hp.insert_cuda(c, torch.ones(u, dtype=torch.bool, device=dev),
                       table.keys, table.fp, 32, "cluster")

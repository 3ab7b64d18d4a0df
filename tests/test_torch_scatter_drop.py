"""The drop-mode masked scatters (kernels/scatter_drop.py, reached through
core/ops.py's set_drop and add_drop) against the JAX reference, and their
CUDA kernel against the plain versions.

On the CPU the plain versions are held to the reference's own form,
`dst.at[jnp.where(ok, idx, cap)].set(src, mode="drop")` and `.add(...)`,
on seeded numpy inputs: f32 rows of 1, 3 and 6, int32 and bool, a scalar
src, no lane and every lane selected, selected lanes whose targets lie
outside [0, rows) (a negative one counted from the end, as the reference
does, the others dropped), and compact_indices.  Results must be
EQUAL: a set copies, and an add makes one f32 add a target (the targets are
distinct).  Both versions share one argument contract, checked here too;
a CPU tensor never loads the CUDA library and a tensor off the CPU never
takes the plain version.

The `cuda` tests compare the kernel with its plain version on the card,
show that a failed build or launch raises, and that the counts split the
wrapper's launches, those it recorded into a CUDA graph, and the kernel's
runs on the device; they skip without a card.  The
reference is imported inside a fixture, so on the GPU machine (no JAX)

    python -m pytest --noconftest -m cuda tests/test_torch_scatter_drop.py
"""

import numpy as np
import pytest
import torch

from immesh_tpu_torch.core import ops
from immesh_tpu_torch.kernels import build
from immesh_tpu_torch.kernels import scatter_drop as sd

_ROWS, _LANES = 97, 60


@pytest.fixture(scope="module")
def jnp():
    import jax.numpy as jnp
    return jnp


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda")


def _case(name, rng):
    """(kind, dst, idx, src, ok) as numpy arrays (src may be a scalar)."""
    f32, i32 = np.float32, np.int32
    idx = rng.permutation(_ROWS)[:_LANES].astype(i32)  # distinct targets
    ok = rng.random(_LANES) < 0.6
    width = {"set_f32_w1": (), "set_f32_w3": (3,), "set_f32_w6": (6,),
             "add_f32_w1": (), "add_f32_w3": (3,), "add_f32_w6": (6,)}
    if name in width:
        row = width[name]
        dst = rng.normal(size=(_ROWS,) + row).astype(f32)
        src = rng.normal(size=(_LANES,) + row).astype(f32)
        return name[:3], dst, idx, src, ok
    if name == "set_int32":
        return ("set", rng.integers(-9, 9, _ROWS).astype(i32), idx,
                rng.integers(-2 ** 31, 2 ** 31 - 1, _LANES).astype(i32), ok)
    if name == "set_bool":
        return ("set", rng.random(_ROWS) < 0.5, idx,
                rng.random(_LANES) < 0.5, ok)
    if name == "set_scalar_true":
        return "set", np.zeros(_ROWS, bool), idx, True, ok
    if name == "set_scalar_zero":
        return "set", rng.integers(1, 9, _ROWS).astype(i32), idx, 0, ok
    if name == "set_no_lane":
        return ("set", rng.normal(size=(_ROWS, 3)).astype(f32), idx,
                rng.normal(size=(_LANES, 3)).astype(f32),
                np.zeros(_LANES, bool))
    if name == "add_every_lane":
        return ("add", rng.normal(size=(_ROWS, 6)).astype(f32), idx,
                rng.normal(size=(_LANES, 6)).astype(f32),
                np.ones(_LANES, bool))
    if name in ("set_out_of_range", "add_out_of_range"):
        return (name[:3], rng.normal(size=(_ROWS, 3)).astype(f32),
                _out_of_range(idx, _ROWS), rng.normal(size=(_LANES, 3))
                .astype(f32), rng.random(_LANES) < 0.8)
    raise KeyError(name)


def _out_of_range(idx, rows):
    """idx with every third lane's target written from the end (t - rows)
    and every fifth lane's moved outside [-rows, rows): the targets that
    remain stay distinct."""
    idx = idx.copy()
    lane = np.arange(idx.shape[0])
    idx[lane % 3 == 0] -= rows
    far = lane % 5 == 0
    idx[far] = np.where(lane[far] % 2 == 0, rows + lane[far],
                        -rows - 1 - lane[far])
    return idx


_CASES = ("set_f32_w1", "set_f32_w3", "set_f32_w6", "add_f32_w1",
          "add_f32_w3", "add_f32_w6", "set_int32", "set_bool",
          "set_scalar_true", "set_scalar_zero", "set_no_lane",
          "add_every_lane", "set_out_of_range", "add_out_of_range",
          "compact_indices")


def _t(x):
    return torch.from_numpy(np.array(x)) if isinstance(x, np.ndarray) else x


@pytest.mark.parametrize("name", _CASES)
def test_plain_scatters_equal_the_reference(jnp, name):
    rng = np.random.default_rng(_CASES.index(name))
    if name == "compact_indices":
        from immesh_tpu.mesh.global_map import _compact_indices
        keep = rng.random(300) < 0.3
        for k in (200, 50):
            np.testing.assert_array_equal(
                np.asarray(_compact_indices(jnp.asarray(keep), k)),
                ops.compact_indices(_t(keep), k).numpy())
        return
    kind, dst, idx, src, ok = _case(name, rng)
    tgt = jnp.where(jnp.asarray(ok), jnp.asarray(idx), _ROWS)
    at = jnp.asarray(dst).at[tgt]
    want = (at.set(src, mode="drop") if kind == "set"
            else at.add(jnp.asarray(src), mode="drop"))
    got = _t(dst)
    (ops.set_drop if kind == "set" else ops.add_drop)(
        got, _t(idx), _t(src), _t(ok))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_both_versions_take_one_argument_contract():
    dst = torch.zeros(8, 3)
    idx = torch.arange(4, dtype=torch.int32)
    ok = torch.ones(4, dtype=torch.bool)
    with pytest.raises(ValueError, match="lanes' shape"):
        ops.set_drop(dst, idx[:3], torch.zeros(3, 3), ok)
    with pytest.raises(ValueError, match="expected"):
        ops.set_drop(dst, idx, torch.zeros(4, 2), ok)
    with pytest.raises(TypeError, match="src is"):
        ops.set_drop(dst, idx, torch.zeros(4, 3, dtype=torch.float64), ok)
    with pytest.raises(TypeError, match="ok must be bool"):
        ops.set_drop(dst, idx, 1.0, ok.int())
    with pytest.raises(TypeError, match="idx must be"):
        ops.set_drop(dst, idx.short(), 1.0, ok)
    with pytest.raises(TypeError, match="f32"):
        ops.add_drop(dst, idx, 1.0, ok)


def test_a_cpu_tensor_never_loads_the_cuda_library(monkeypatch):
    def no_build(name):
        raise AssertionError(f"the CPU path loaded lib{name}")

    monkeypatch.setattr(build, "load", no_build)
    monkeypatch.setattr(sd, "_lib", None)
    monkeypatch.setattr(sd, "launches", 0)
    dst = torch.zeros(8)
    ops.set_drop(dst, torch.tensor([1, 5]), torch.tensor([2.0, 3.0]),
                 torch.tensor([True, True]))
    ops.add_drop(dst, torch.tensor([5]), torch.tensor([1.0]),
                 torch.tensor([True]))
    assert dst.tolist() == [0, 2, 0, 0, 0, 4, 0, 0] and sd.launches == 0
    assert sd.captured == 0 and sd.runs() == 0


def test_a_tensor_off_the_cpu_never_takes_the_plain_version(monkeypatch):
    def plain(*args):
        raise AssertionError("the plain version ran on a tensor off the CPU")

    monkeypatch.setattr(sd, "set_plain", plain)
    monkeypatch.setattr(sd, "add_plain", plain)
    dst = torch.empty((16, 3), device="meta")
    idx = torch.empty(4, dtype=torch.int32, device="meta")
    ok = torch.empty(4, dtype=torch.bool, device="meta")
    src = torch.empty((4, 3), device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        ops.set_drop(dst, idx, src, ok)
    with pytest.raises(ValueError, match="CUDA device"):
        ops.add_drop(dst, idx, src, ok)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
def _card_call(dev, g, kind, dtype, row, n, idx_dtype=torch.int32,
               src_kind="tensor", out_of_range=False):
    """A random call of n lanes into 2n rows, on the card (with targets
    outside [0, 2n) as _out_of_range makes them)."""
    def rand(shape):
        if dtype == torch.bool:
            return torch.rand(shape, generator=g, device=dev) < 0.5
        if dtype.is_floating_point:
            return torch.randn(shape, generator=g, device=dev)
        return torch.randint(-2 ** 30, 2 ** 30, shape, generator=g,
                             device=dev).to(dtype)

    dst = rand((2 * n,) + row)
    idx = torch.randperm(2 * n, generator=g, device=dev)[:n].to(idx_dtype)
    if out_of_range:
        idx = torch.from_numpy(_out_of_range(idx.cpu().numpy(), 2 * n)).to(dev)
    ok = torch.rand(n, generator=g, device=dev) < 0.7
    if src_kind == "strided":
        w = int(np.prod(row)) if row else 1
        src = rand((n, w + 4))[:, 1:1 + w].reshape((n,) + row)
    elif src_kind == "tensor":
        src = rand((n,) + row)
    else:
        src = src_kind
    return kind, dst, idx, src, ok


@pytest.mark.cuda
@pytest.mark.parametrize("spec", [
    ("set", torch.float32, (), torch.int32, "tensor"),
    ("set", torch.float32, (3,), torch.int64, "strided"),
    ("set", torch.float32, (6,), torch.int32, "tensor"),
    ("set", torch.int32, (), torch.int32, "tensor"),
    ("set", torch.bool, (), torch.int32, True),
    ("set", torch.int32, (), torch.int64, 0),
    ("add", torch.float32, (), torch.int32, "strided"),
    ("add", torch.float32, (6,), torch.int32, "tensor"),
    ("set", torch.float32, (3,), torch.int64, "tensor", True),
    ("add", torch.float32, (3,), torch.int32, "tensor", True)])
def test_kernel_equals_the_plain_version_on_the_card(dev, spec):
    """More lanes than the card holds threads: each thread strides."""
    kind, dtype, row, idx_dtype, src_kind, *out_of_range = spec
    props = torch.cuda.get_device_properties(dev)
    n = 2 * props.multi_processor_count * props.max_threads_per_multi_processor
    g = torch.Generator(device=dev).manual_seed(3)
    _, dst, idx, src, ok = _card_call(dev, g, kind, dtype, row, n, idx_dtype,
                                      src_kind, bool(out_of_range))
    a, b = dst.clone(), dst.clone()
    before = sd.launches
    (sd.set_cuda if kind == "set" else sd.add_cuda)(a, idx, src, ok)
    (sd.set_plain if kind == "set" else sd.add_plain)(b, idx, src, ok)
    torch.cuda.synchronize()
    assert sd.launches == before + 1
    if a.is_floating_point():
        a, b = a.view(torch.int32), b.view(torch.int32)
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_a_failed_build_or_launch_raises(dev, monkeypatch):
    dst = torch.zeros(8, device=dev)
    idx = torch.arange(4, dtype=torch.int32, device=dev)
    ok = torch.ones(4, dtype=torch.bool, device=dev)

    def broken(name):
        raise RuntimeError("building the port's native sources failed")

    monkeypatch.setattr(sd, "_lib", None)
    monkeypatch.setattr(build, "load", broken)
    with pytest.raises(RuntimeError, match="failed"):
        ops.set_drop(dst, idx, 1.0, ok)
    monkeypatch.undo()
    monkeypatch.setattr(sd, "max_blocks", lambda index: 0)  # refused
    with pytest.raises(RuntimeError, match="launch failed"):
        ops.set_drop(dst, idx, 1.0, ok)


@pytest.mark.cuda
def test_counts_split_launches_captured_and_device_runs(dev):
    """An eager call counts in `launches`; one under stream capture in
    `captured`; the kernel's device counter sees the eager run and every
    replay of the graph."""
    dst = torch.zeros(64, device=dev)
    idx = torch.arange(8, dtype=torch.int32, device=dev)
    ok = torch.ones(8, dtype=torch.bool, device=dev)
    src = torch.ones(8, device=dev)
    ops.set_drop(dst, idx, 1.0, ok)    # loads the library before a capture
    sd.reset_launches()
    ops.set_drop(dst, idx, 1.0, ok)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        ops.add_drop(dst, idx, src, ok)
    assert (sd.launches, sd.captured, sd.runs()) == (1, 1, 1)
    for _ in range(3):
        graph.replay()
    assert (sd.launches, sd.captured, sd.runs()) == (1, 1, 4)
    assert dst[:8].tolist() == [4.0] * 8
    sd.reset_launches()
    assert (sd.launches, sd.captured, sd.runs()) == (0, 0, 0)

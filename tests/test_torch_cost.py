"""``launch.cost.CostCounter`` (the port's per-device cost counter) against
the JAX package's loop-aware HLO walk (``repro.launch.hlo_cost``).

* The programs of ``tests/test_sharding_policy.py``'s ``hlo_cost`` tests (a
  matmul, a scanned loop of 7, a scan of 5 over a scan of 3; the port runs
  the loops in Python): FLOPs equal to ``module_cost``'s.
* A ``DTensor`` product on a fake (2, 4) world (``init_fake_world``, this
  process rank 7 of 8, started and ended by a module fixture that fails if
  a group was running) counts one rank's share: 1/8 of the whole product
  when both its dims are split, the whole product when the operands are
  replicated; DTensor's shape propagation at the global shape is not
  counted.
* The collectives of a ``redistribute`` (a dim split over "model" made
  whole; the partial sums of a product contracted over "model" made whole)
  equal in kind, count and result bytes the ones of JAX's program for the
  same layouts on the 8 fake devices.
* Each kernel's operator (``torch.ops.repro_torch.flash_attention``,
  ``flash_attention_lse``, ``ssd_chunk``) gives fake and ``meta`` inputs
  outputs of the plain version's shapes and dtypes, refuses what the kernel
  does not take, and the counter sees each call as one operator at
  ``flash_cost`` / ``ssd_chunk_cost``'s FLOPs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as JP
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro.launch.hlo_cost import module_cost
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention_cuda import flash_cost
from repro_torch.kernels.ssd_chunk_cuda import ssd_chunk_cost
from repro_torch.launch.cost import CostCounter, ring_bytes
from repro_torch.launch.mesh import init_fake_world, make_small_mesh


@pytest.fixture(scope="module")
def mesh():
    init_fake_world(8)          # raises if a process group is running
    try:
        yield make_small_mesh((2, 4), device_type="cpu")
    finally:
        dist.destroy_process_group()


def _jax_flops(f, *shapes):
    args = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
    return module_cost(jax.jit(f).lower(*args).compile().as_text(), 1).flops


def test_counter_plain_matmul_equals_hlo_cost():
    with FakeTensorMode(), CostCounter() as c:
        torch.empty(32, 128) @ torch.empty(128, 16)
    assert c.cost.flops == _jax_flops(lambda a, b: a @ b, (32, 128), (128, 16))
    assert c.cost.flops == 2 * 32 * 128 * 16


def test_counter_scanned_loop_equals_hlo_cost():
    def jf(x):
        def body(c, _):
            return c @ c, None
        return jax.lax.scan(body, x, None, length=7)[0]

    with FakeTensorMode(), CostCounter() as c:
        x = torch.empty(64, 64)
        for _ in range(7):
            x = x @ x
    assert c.cost.flops == pytest.approx(_jax_flops(jf, (64, 64)), rel=1e-12)
    assert c.cost.flops == 7 * 2 * 64 ** 3


def test_counter_nested_loops_equal_hlo_cost():
    def jf(x):
        def outer(c, _):
            def inner(d, _):
                return d @ d, None
            return jax.lax.scan(inner, c, None, length=3)[0], None
        return jax.lax.scan(outer, x, None, length=5)[0]

    with FakeTensorMode(), CostCounter(memory=True) as c:
        x = torch.empty(32, 32)
        for _ in range(5):
            for _ in range(3):
                x = x @ x
    assert c.cost.flops == pytest.approx(_jax_flops(jf, (32, 32)), rel=1e-12)
    assert c.cost.flops == 15 * 2 * 32 ** 3
    # one 4 KiB block live at a time, the next made before the last dies
    assert c.peak == 2 * 32 * 32 * 4


def _dt(mesh, local_shape, placements, shape, grad=False):
    local = torch.empty(local_shape, requires_grad=grad)
    return DTensor.from_local(local, mesh, placements, run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta").stride())


def test_dtensor_product_counts_one_ranks_share(mesh):
    M, K, N = 4096, 1024, 4096
    whole = 2.0 * M * K * N
    with FakeTensorMode():
        a = _dt(mesh, (M // 2, K), [Shard(0), Replicate()], (M, K))
        b = _dt(mesh, (K, N // 4), [Replicate(), Shard(1)], (K, N))
        with CostCounter() as c:
            out = a @ b
        assert tuple(out.to_local().shape) == (M // 2, N // 4)
        assert c.cost.flops == whole / 8
        assert not c.cost.collectives
        ar = _dt(mesh, (M, K), [Replicate(), Replicate()], (M, K))
        br = _dt(mesh, (K, N), [Replicate(), Replicate()], (K, N))
        with CostCounter() as c:
            ar @ br
        assert c.cost.flops == whole


def _jax_collectives(f, in_specs, out_spec, shapes):
    jmesh = Mesh(np.asarray(jax.devices()[:8]).reshape(2, 4), ("data", "model"))
    jit = jax.jit(f, in_shardings=tuple(NamedSharding(jmesh, s) for s in in_specs),
                  out_shardings=NamedSharding(jmesh, out_spec))
    args = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
    return module_cost(jit.lower(*args).compile().as_text(), 8).collectives


def _kinds(colls):
    return {k: (int(v["count"]), int(v["bytes"])) for k, v in colls.items()}


def test_redistribute_collectives_equal_jax(mesh):
    # a dim split over "model" made whole: one all-gather of the whole
    with FakeTensorMode():
        x = _dt(mesh, (256, 512 // 4), [Replicate(), Shard(1)], (256, 512))
        with CostCounter() as c:
            x.redistribute(mesh, [Replicate(), Replicate()])
    jax_c = _jax_collectives(lambda a: a * 1.0, [JP(None, "model")], JP(), [(256, 512)])
    assert _kinds(c.cost.collectives) == _kinds(jax_c) == {"all-gather": (1, 256 * 512 * 4)}
    assert c.cost.collectives["all-gather"]["ring_bytes"] == ring_bytes(
        "all-gather", 256 * 512 * 4, 4)

    # a product contracted over "model": its partial sums all-reduced
    with FakeTensorMode():
        a = _dt(mesh, (128, 256 // 4), [Replicate(), Shard(1)], (128, 256))
        b = _dt(mesh, (256 // 4, 64), [Replicate(), Shard(0)], (256, 64))
        with CostCounter() as c:
            out = a @ b
            assert isinstance(out.placements[1], Partial)
            out.redistribute(mesh, [Replicate(), Replicate()])
    jax_c = _jax_collectives(lambda a, b: a @ b, [JP(None, "model"), JP("model", None)],
                             JP(), [(128, 256), (256, 64)])
    assert _kinds(c.cost.collectives) == _kinds(jax_c) == {"all-reduce": (1, 128 * 64 * 4)}
    assert c.cost.flops == 2.0 * 128 * 64 * 256 / 4


def test_the_ports_own_collectives_are_counted(mesh):
    from repro_torch.collectives import MeshGroups, all_gather_ordered, psum
    groups = MeshGroups(mesh)
    with FakeTensorMode(allow_non_fake_inputs=True):
        t = torch.empty(3, 5)
        with CostCounter() as c:
            all_gather_ordered(t, groups, "model", 1)
            psum(t, groups, ("data", "model"))
    assert _kinds(c.cost.collectives) == {"all-gather": (1, 4 * 3 * 5 * 4),
                                          "all-reduce": (1, 3 * 5 * 4)}


@pytest.mark.parametrize("device", ["fake", "meta"])
def test_kernel_operators_give_the_plain_versions_shapes(device):
    B, Sq, Sk, H, D = 2, 24, 40, 4, 32
    Q, P, N = 16, 8, 16
    gen = torch.Generator().manual_seed(0)
    real = {"q": torch.randn(B, Sq, H, D, generator=gen),
            "k": torch.randn(B, Sk, H, D, generator=gen),
            "x": torch.randn(B, Q, H, P, generator=gen),
            "dt": torch.rand(B, Q, H, generator=gen),
            "A": -torch.rand(H, generator=gen),
            "Bc": torch.randn(B, Q, 1, N, generator=gen).expand(B, Q, H, N),
            "s": torch.randn(B, H, P, N, generator=gen)}
    o_ref = ref.flash_attention_ref(real["q"], real["k"], real["k"], False)
    o_lse = ref.flash_attention_fwd_lse(real["q"], real["k"], real["k"], True)
    y_ref = ref.ssd_chunk_ref(real["x"], real["dt"], real["A"], real["Bc"], real["Bc"],
                              real["s"])
    mode = FakeTensorMode() if device == "fake" else None
    ops = torch.ops.repro_torch
    with mode if mode else torch.no_grad(), CostCounter() as c:
        t = {k: (torch.empty(v.shape, dtype=v.dtype, device="cpu" if mode else "meta")
                 if k != "Bc" else torch.empty(B, Q, 1, N, device="cpu" if mode
                                               else "meta").expand(B, Q, H, N))
             for k, v in real.items()}
        o = ops.flash_attention(t["q"], t["k"], t["k"], False, None)
        o2, lse = ops.flash_attention_lse(t["q"], t["k"], t["k"], True, 0.5)
        y, s = ops.ssd_chunk(t["x"], t["dt"], t["A"], t["Bc"], t["Bc"], t["s"])
        with pytest.raises(ValueError, match="head dim"):
            ops.flash_attention(t["q"][..., :24], t["k"][..., :24], t["k"][..., :24],
                                True, None)
        with pytest.raises(TypeError, match="float32"):
            ops.ssd_chunk(t["x"].double(), t["dt"], t["A"], t["Bc"], t["Bc"], t["s"])
    for got, want in ((o, o_ref), (o2, o_lse[0]), (lse, o_lse[1]), (y, y_ref[0]),
                      (s, y_ref[1])):
        assert (tuple(got.shape), got.dtype) == (tuple(want.shape), want.dtype)
    assert c.launches("flash_attention") == 1 and c.launches("flash_attention_lse") == 1
    assert c.launches("ssd_chunk") == 1
    assert c.cost.flops == (flash_cost(B, Sq, Sk, H, D, False, 4)[0]
                            + flash_cost(B, Sq, Sk, H, D, True, 4)[0]
                            + ssd_chunk_cost(B, Q, H, P, N, 1)[0])


def test_meta_allocations_add_nothing_to_the_peak():
    """A ``meta`` tensor made inside the counter (a stride computed from
    one, as the traced prefill once did) holds no device memory: the peak
    counts the real storage only."""
    with FakeTensorMode(), CostCounter(memory=True) as c:
        a = torch.empty(64, 64)
        big = torch.empty(32, 32, 32768, 32, 96, device="meta")
        assert big.stride()[0] == 32 * 32768 * 32 * 96
        b = a + 1
    assert c.peak == 2 * 64 * 64 * 4
    del a, b, big


def test_live_at_peak_names_the_operators_alive_at_the_peak():
    """``attribute=True``: the storages alive at the peak, grouped by the
    operator, shape, dtype and line that made them; a storage freed before
    the peak is not among them."""
    with FakeTensorMode(), CostCounter(attribute=True) as c:
        a = torch.empty(64, 64)
        gone = a * 2
        del gone
        b = torch.cat([a, a])             # 2 x 64 x 64
        d = b.exp()                       # the peak: a, b, d alive
        del b
    rows = c.live_at_peak()
    assert c.peak == 64 * 64 * 4 * (1 + 2 + 2)
    assert sum(n for n, _, _ in rows) == c.peak
    got = {(op, shape, dtype): (n, count) for n, count, (op, shape, dtype, _) in rows}
    assert got == {("empty", (64, 64), "float32"): (64 * 64 * 4, 1),
                   ("cat", (128, 64), "float32"): (2 * 64 * 64 * 4, 1),
                   ("exp", (128, 64), "float32"): (2 * 64 * 64 * 4, 1)}
    del a, d


def test_a_collectives_wait_counts_as_its_input(mesh):
    """``wait_tensor`` returns its input on a device (its fake kernel makes
    a copy): a gather made whole and waited for holds one buffer, alive
    while either tensor is."""
    x = _dt(mesh, (4, 8), [Replicate(), Shard(0)], (16, 8))
    with FakeTensorMode(allow_non_fake_inputs=True), CostCounter(memory=True) as c:
        y = x.redistribute(mesh, [Replicate(), Replicate()]).to_local()
        assert tuple(y.shape) == (16, 8)
    assert c.ops[torch.ops._c10d_functional.wait_tensor.default] >= 1
    assert c.peak == 16 * 8 * 4
    del y

"""The port's LSTM stack (``ops.lstm_stack``, one kernel launch per RevPred
or Tributary forward on the card) against the per-step cell loop it
replaces and against the JAX package's ``revpred._run_lstm_stack``.

On the CPU the stack takes its plain version, ``ref.lstm_stack_ref``; the
kernel itself is held against it on the card (``test_torch_kernels_cuda.py``
and ``chip_smoke.py``).  Inputs are made from a seed with numpy and handed to
both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_port  # noqa: F401  (one intra-op thread)

import repro.core.revpred as jr
from repro_torch.kernels import lstm_cell as klc
from repro_torch.kernels import ops, ref

F32_TOL = 1e-5       # the Pallas cell's float32 tolerance (tests/test_kernels.py)
BF16_TOL = 3e-2


def _stack(rng, G, T, I, H, n_layers=3):
    """numpy xs (G,1,T,I) and layers with random weights and biases."""
    xs = rng.standard_normal((G, 1, T, I)).astype(np.float32)
    layers = []
    for n in range(n_layers):
        d = I if n == 0 else H
        layers.append({
            "w_ih": (rng.standard_normal((G, d, 4 * H)) / np.sqrt(d)).astype(np.float32),
            "w_hh": (rng.standard_normal((G, H, 4 * H)) / np.sqrt(H)).astype(np.float32),
            "b": (rng.standard_normal((G, 4 * H)) * 0.1).astype(np.float32)})
    return xs, layers


def _torch(xs, layers, dtype=torch.float32):
    return (torch.from_numpy(xs).to(dtype),
            [{k: torch.from_numpy(v).to(dtype) for k, v in lp.items()}
             for lp in layers])


def _cell_loop(xs, layers):
    """The per-step loop ``revpred._run_lstm_stack`` ran before the stack:
    one ``lstm_cell_ref`` call per step per layer."""
    G, B = xs.shape[:2]
    seq = xs.permute(2, 0, 1, 3).contiguous()
    for lp in layers:
        H = lp["w_hh"].shape[-2]
        h = torch.zeros(G, B, H, dtype=xs.dtype)
        c = torch.zeros_like(h)
        hs = []
        for t in range(seq.shape[0]):
            h, c = ref.lstm_cell_ref(seq[t], h, c, lp["w_ih"], lp["w_hh"], lp["b"])
            hs.append(h)
        seq = torch.stack(hs)
    return h


# revpred's history (I = 6, T = 59) and tributary's (I = 7, T = 60)
SHAPES = [(I, T, H, G) for I, T in ((6, 59), (7, 60)) for H in (16, 32)
          for G in (1, 3)]


@pytest.mark.parametrize("I,T,H,G", SHAPES)
def test_stack_ref_matches_cell_loop_and_jax(I, T, H, G):
    rng = np.random.default_rng(100 * I + H + G)
    xs, layers = _stack(rng, G, T, I, H)
    tx, tl = _torch(xs, layers)
    got = ref.lstm_stack_ref(tx, tl)
    assert got.shape == (G, 1, H) and got.dtype == torch.float32
    assert torch.equal(got, _cell_loop(tx, tl))
    run = jax.vmap(jr._run_lstm_stack)
    want = np.asarray(run(jax.tree.map(jnp.asarray, layers), jnp.asarray(xs)))
    np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("I,T,H", [(6, 59, 32), (7, 60, 16)])
def test_stack_ref_bf16_matches_cell_loop(I, T, H):
    """In bfloat16 h and c round at every step, as the cell's outputs do."""
    xs, layers = _stack(np.random.default_rng(7), 2, T, I, H)
    tx, tl = _torch(xs, layers, torch.bfloat16)
    got = ref.lstm_stack_ref(tx, tl)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, _cell_loop(tx, tl))
    f32 = ref.lstm_stack_ref(*_torch(xs, layers))
    np.testing.assert_allclose(got.float().numpy(), f32.numpy(), rtol=BF16_TOL,
                               atol=BF16_TOL)


def test_groups_and_rows_are_independent():
    """A (group, row)'s h does not depend on its neighbours in the call, up
    to the float32 rounding of a product batched another way."""
    xs, layers = _stack(np.random.default_rng(3), 4, 20, 6, 16)
    xs = np.concatenate([xs, xs[:, ::-1] * 0.5], axis=1)     # B = 2
    tx, tl = _torch(np.ascontiguousarray(xs), layers)
    h = ref.lstm_stack_ref(tx, tl)
    for g in range(4):
        for b in range(2):
            one = ref.lstm_stack_ref(tx[g:g + 1, b:b + 1],
                                     [{k: v[g:g + 1] for k, v in lp.items()}
                                      for lp in tl])
            torch.testing.assert_close(one[0, 0], h[g, b], rtol=0, atol=1e-6)


def test_cpu_tensors_take_the_plain_version():
    tx, tl = _torch(*_stack(np.random.default_rng(4), 2, 12, 6, 16))
    before = klc.STACK_LAUNCHES, klc.LAUNCHES
    assert torch.equal(ops.lstm_stack(tx, tl), ref.lstm_stack_ref(tx, tl))
    assert (klc.STACK_LAUNCHES, klc.LAUNCHES) == before


def test_forced_kernel_on_cpu_tensors_raises():
    """No fallback: asking for the kernel on a CPU tensor raises instead of
    returning the plain result, and counts no launch."""
    tx, tl = _torch(*_stack(np.random.default_rng(5), 1, 8, 6, 16))
    before = klc.STACK_LAUNCHES
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.lstm_stack(tx, tl, force="cuda")
    with pytest.raises(ValueError, match="unknown"):
        ops.lstm_stack(tx, tl, force="pallas")
    assert klc.STACK_LAUNCHES == before


@pytest.mark.parametrize("I,H,T", [(6, 16, 59), (7, 32, 60), (6, 64, 59),
                                   (7, 64, 60)])
def test_smem_budget_admits_up_to_hidden_64(I, H, T):
    wave, rows, smem = klc.lstm_stack_plan(4, I, H, T)
    assert wave in (1, 3) and 1 <= rows <= 4
    assert wave * rows * H * klc.LANES <= klc.MAX_THREADS
    assert smem == klc.lstm_stack_smem_bytes(I, H, T, rows, 3, wave) <= klc.SMEM_LIMIT
    # the weights of the resident layers, as float32, are the bulk of it
    assert smem >= 4 * wave * 2 * H * 4 * H


def test_smem_budget_raises_for_hidden_128():
    with pytest.raises(ValueError, match="shared memory"):
        klc.lstm_stack_plan(1, 6, 128, 59)
    assert klc.lstm_stack_smem_bytes(6, 128, 59, 1, 3, 1) > klc.SMEM_LIMIT
    with pytest.raises(ValueError, match="multiple of 4"):
        klc.lstm_stack_plan(1, 6, 30, 59)


def test_smem_budget_waves_and_rows():
    """RevPred's widths run all three layers as one wavefront; hidden 64
    runs one layer at a time.  Then rows fill 1024 threads (8H a layer
    and row) and the memory limit."""
    assert klc.lstm_stack_plan(1, 6, 32, 59)[:2] == (3, 1)
    assert klc.lstm_stack_plan(40, 6, 32, 59)[:2] == (3, 1)
    assert klc.lstm_stack_plan(40, 7, 16, 60)[:2] == (3, 2)
    assert klc.lstm_stack_plan(1, 6, 16, 59)[:2] == (3, 1)
    assert klc.lstm_stack_plan(40, 6, 64, 60)[:2] == (1, 2)
    # the budget mirrors the kernel's layout: padded weight rows, one
    # output buffer per layer of the wave
    assert klc.lstm_stack_smem_bytes(6, 32, 59, 1, 3, 3) == 4 * (
        (32 + 32 + 2 * 64) * 144 + 3 * 128 + 59 * 6 + 3 * 59 * 32)


# --------------------------------------------------------------------------
# the backward: the plain versions of the training kernels
# --------------------------------------------------------------------------

GRAD_TOL = 1e-5   # of each gradient leaf's largest magnitude


@pytest.mark.parametrize("B,T,I,H,L", [(4, 59, 6, 32, 3), (3, 60, 7, 16, 3),
                                       (1, 9, 6, 8, 1), (5, 11, 6, 8, 2)])
def test_stack_backward_plain_versions_match_jax_and_autograd(B, T, I, H, L):
    """What the kernels compute (the training forward's saved state, the
    backward's dgates, then ``stack_weight_grads``' products) equals
    ``jax.grad`` of the JAX package's ``_run_lstm_stack`` and autograd of
    ``ref.lstm_stack_ref``, leaf by leaf within 1e-5 of its largest
    magnitude (float32 sums taken in other orders)."""
    rng = np.random.default_rng(B * 100 + H)
    xs_np, layers_np = _stack(rng, 1, T, I, H, L)
    xs_np = np.repeat(xs_np, B, axis=1) + rng.standard_normal(
        (1, B, T, I)).astype(np.float32)
    dh_np = rng.standard_normal((1, B, H)).astype(np.float32)
    xs, layers = _torch(xs_np, layers_np)
    dh = torch.from_numpy(dh_np)
    with torch.no_grad():
        h, gates, c, hs = ref.lstm_stack_fwd_train_ref(xs, layers)
        dgates = ref.lstm_stack_bwd_ref(dh, gates, c, layers)
        got = klc.stack_weight_grads(xs, hs, dgates, layers, [True] * (1 + 3 * L))

    flat = [xs.requires_grad_(True)] + [lp[k].requires_grad_(True)
                                        for lp in layers for k in ("w_ih", "w_hh", "b")]
    want = torch.autograd.grad(ref.lstm_stack_ref(xs, layers), flat, dh)

    jp = [{k: jnp.asarray(v[0]) for k, v in lp.items()} for lp in layers_np]
    jseq = jnp.asarray(xs_np[0])
    jdh = jnp.asarray(dh_np[0])
    gp, gx = jax.grad(lambda p, s: jnp.sum(jr._run_lstm_stack(p, s) * jdh),
                      argnums=(0, 1))(jp, jseq)
    jax_flat = [np.asarray(gx)[None]] + [np.asarray(g[k])[None] for g in gp
                                         for k in ("w_ih", "w_hh", "b")]
    assert torch.equal(h, ref.lstm_stack_ref(xs.detach(), layers))
    for a, b, j in zip(got, want, jax_flat):
        scale = float(np.abs(j).max())
        assert a.shape == b.shape == j.shape
        assert float((a - b).abs().max()) <= GRAD_TOL * scale
        assert float(np.abs(a.numpy() - j).max()) <= GRAD_TOL * scale


def test_ops_lstm_stack_trains_by_autograd_on_cpu():
    xs, layers = _torch(*_stack(np.random.default_rng(1), 2, 12, 6, 8))
    for lp in layers:
        for t in lp.values():
            t.requires_grad_(True)
    before = klc.TRAIN_LAUNCHES, klc.BWD_LAUNCHES
    h = ops.lstm_stack(xs, layers)
    h.sum().backward()
    assert (klc.TRAIN_LAUNCHES, klc.BWD_LAUNCHES) == before
    assert all(lp[k].grad is not None and torch.isfinite(lp[k].grad).all()
               for lp in layers for k in lp)


def _threads(H, wave):
    """A training block's threads: 4H a layer of the wave, whole warps."""
    return -(-wave * 4 * H // 32) * 32


@pytest.mark.parametrize("H,T,L", [(16, 60, 3), (32, 59, 3), (32, 60, 3),
                                   (64, 59, 3), (32, 59, 1)])
def test_backward_smem_budget(H, T, L):
    """The backward's plan at the training batch on an H100's 132 SMs: one
    wave of blocks, within a block's threads and shared memory."""
    wave, rows, blocks, smem = klc.lstm_stack_bwd_plan(256, H, T, L, 132)
    assert smem == klc.lstm_stack_bwd_smem_bytes(H, T, rows, L, wave) <= klc.SMEM_LIMIT
    assert _threads(H, wave) <= klc.TRAIN_MAX_THREADS[max(H, 16)] <= klc.MAX_THREADS
    assert wave in (1, L) and rows in klc.TRAIN_ROWS
    assert blocks == -(-256 // rows) <= 132
    if H <= 32:
        assert wave == L       # every layer at once: T + L - 1 dependent steps
    with pytest.raises(ValueError, match="registers"):
        klc.lstm_stack_bwd_plan(1, 128, T, L, 132)


@pytest.mark.parametrize("B", [1, 7, 255, 256, 257])
def test_training_plans_run_in_one_wave(B):
    """Both training plans at RevPred's widths put every block on an SM of
    its own (132 on an H100), with the fewest rows a block that do."""
    plans = [(klc.lstm_stack_train_plan(B, 6, 32, 59, 3, 132),
              lambda rows, wave: klc.lstm_stack_train_smem_bytes(6, 32, 59, rows, 3, wave)),
             (klc.lstm_stack_bwd_plan(B, 32, 59, 3, 132),
              lambda rows, wave: klc.lstm_stack_bwd_smem_bytes(32, 59, rows, 3, wave))]
    for (wave, rows, blocks, smem), smem_of in plans:
        assert wave == 3 and blocks == -(-B // rows) <= 132
        assert rows == 1 or -(-B // (rows // 2)) > 132
        assert _threads(32, wave) == 384 <= klc.MAX_THREADS
        assert smem == smem_of(rows, wave) <= klc.SMEM_LIMIT


def test_training_plans_at_revpred_training_batch():
    """RevPred's training batch (B = 256, T = 59, I = 6, H = 32, 3 layers):
    2 rows a block, 128 blocks, and the kernels' shared-memory layouts to
    the byte (the weights are in registers)."""
    assert klc.lstm_stack_train_plan(256, 6, 32, 59, 3, 132) == (3, 2, 128, 24960)
    # x over 59 steps and a two-step ring of h per layer, 2 rows each; a
    # row split over 4 k-lanes in segments of 32 / 4 floats, each padded by 4
    assert 24960 == 4 * (59 + 3 * 2) * 2 * 4 * (8 + 4)
    assert klc.lstm_stack_bwd_plan(256, 32, 59, 3, 132) == (3, 2, 128, 17152)
    # dgates (4H over 8 k-lanes: segments of 32 / 2 floats, padded by 4),
    # the recurrent dh, the two-step dx rings of the two handing layers, the
    # cp.async ring (3 steps x 5 floats a layer, row and unit)
    assert 17152 == 4 * (3 * 2 * 8 * (16 + 4) + 3 * 2 * 32 + 2 * 2 * 2 * 32
                         + 3 * 5 * 3 * 2 * 32)
    # Tributary's (T = 60, I = 7) and two groups (4 rows a block)
    assert klc.lstm_stack_train_plan(256, 7, 32, 60, 3, 132)[:3] == (3, 2, 128)
    assert klc.lstm_stack_train_plan(256, 6, 32, 59, 3, 132, G=2)[:3] == (3, 4, 128)
    assert klc.lstm_stack_bwd_plan(256, 32, 59, 3, 132, G=2)[:3] == (3, 4, 128)


def test_training_plans_beyond_one_wave_and_their_limits():
    """Rows a block are 1, 2 or 4 (the kernels' template argument); where 4
    cannot bring the grid within the SMs the plan takes 4 (the fewest
    waves); H = 64 runs a layer at a time (256 threads of 128 weight
    registers each); widths over 64 and H not a multiple of 4 raise."""
    assert klc.lstm_stack_train_plan(300, 6, 32, 59, 3, 132)[1:3] == (4, 75)
    assert klc.lstm_stack_train_plan(1000, 6, 32, 59, 3, 132)[1:3] == (4, 250)
    assert klc.lstm_stack_bwd_plan(256, 32, 59, 3, 16)[1:3] == (4, 64)
    wave, rows, blocks, smem = klc.lstm_stack_train_plan(256, 6, 64, 59, 3, 132)
    assert (wave, rows, blocks) == (1, 2, 128)
    # segments of 64 / 4 floats for x, the layer below's h and the ring
    assert smem == 4 * (59 + 1 * 2) * 2 * 4 * (16 + 4)
    assert klc.lstm_stack_bwd_plan(256, 64, 59, 3, 132)[:3] == (1, 2, 128)
    with pytest.raises(ValueError, match="registers"):
        klc.lstm_stack_train_plan(256, 100, 32, 59, 3, 132)
    with pytest.raises(ValueError, match="multiple of 4"):
        klc.lstm_stack_bwd_plan(256, 30, 59, 3, 132)


def test_kernels_without_a_backward_refuse_grad_before_anything_else():
    """Every kernel wrapper but the stack's training path raises where a
    gradient would be lost (grad mode on, an input requiring grad), before
    it looks at the device; with grad off the same call fails on the
    device instead."""
    from repro_torch.kernels import flash_attention_cuda as kfa
    from repro_torch.kernels import soa_step_cuda as ksc
    from repro_torch.kernels import ssd_chunk_cuda as kss
    w = torch.zeros(1, 4, 32, requires_grad=True)
    cell = (torch.zeros(1, 1, 4), torch.zeros(1, 1, 8), torch.zeros(1, 1, 8),
            w, torch.zeros(1, 8, 32), torch.zeros(1, 32))
    xs, layers = _torch(*_stack(np.random.default_rng(0), 1, 5, 6, 8))
    layers[0]["b"].requires_grad_(True)
    q = torch.zeros(1, 4, 2, 16, requires_grad=True)
    ssd = (q.new_zeros(1, 4, 1, 4, requires_grad=True), torch.zeros(1, 4, 1),
           torch.zeros(1), torch.zeros(1, 4, 1, 4), torch.zeros(1, 4, 1, 4),
           torch.zeros(1, 1, 4, 4))
    obs = torch.zeros(2, 3, dtype=torch.float64, requires_grad=True)
    fold = (obs, torch.zeros(2, dtype=torch.int64), torch.zeros(2, dtype=torch.float64),
            torch.zeros(2, dtype=torch.bool), torch.zeros(2, dtype=torch.float64))
    seg = (torch.zeros(2, dtype=torch.int64), torch.zeros(2, dtype=torch.int64), 1)
    # flash attention and the SSD chunk train through their autograd
    # Functions (``ops``): their raw wrappers name that route
    calls = [(lambda: klc.lstm_cell_cuda(*cell), "no backward yet .ROADMAP A10"),
             (lambda: klc.lstm_stack_cuda(xs, layers), "no backward yet .ROADMAP A10"),
             (lambda: kfa.flash_attention_cuda(q, q, q),
              "no gradient; train through ops.flash_attention"),
             (lambda: kss.ssd_chunk_cuda(*ssd), "no gradient; train through ops.ssd_chunk"),
             (lambda: ksc.ewma_fold_cuda(*fold), "no backward yet .ROADMAP A10"),
             (lambda: ksc.soa_step_fused_cuda(*fold, *seg), "no backward yet .ROADMAP A10")]
    for call, match in calls:
        with pytest.raises(RuntimeError, match=match):
            call()
        with torch.no_grad(), pytest.raises(ValueError):
            call()

"""The port's checkpointing against the JAX package's.

``tests/test_checkpoint.py`` in the port's terms (round trip, a torn write
ignored, async save, retention, the 2-minute-notice deadline model, a
specific step, the placement hook, the full train state, ``Trainer``
restart within 1e-5 of the uninterrupted run), and the on-store layout
shared with ``repro.checkpoint``: a checkpoint that either package writes
is read by the other leaf for leaf, bfloat16 included, with the same
manifest (tree structure, key strings, shapes, dtypes).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_port  # noqa: F401  (one intra-op thread)

from repro.checkpoint import restore_pytree as jrestore
from repro.checkpoint import save_pytree as jsave
from repro_torch.checkpoint import (CheckpointManager, LocalObjectStore,
                                    ThrottledStore, latest_step, restore_pytree,
                                    save_pytree)
from repro_torch.checkpoint.checkpointer import MANIFEST, steps, tree_bytes
from repro_torch.configs.base import get_config
from repro_torch.launch.train import Trainer
from repro_torch.optim.optimizers import tree_leaves

RESTART_RTOL = 1e-5     # tests/test_checkpoint.py's tolerance


@pytest.fixture
def store(tmp_path):
    return LocalObjectStore(str(tmp_path / "s3"))


def tree():
    return {"a": torch.arange(12, dtype=torch.float32).reshape(3, 4),
            "b": {"c": torch.ones((2, 2), dtype=torch.bfloat16)}}


def _equal(x, y):
    assert type(x) is type(y)
    if isinstance(x, torch.Tensor):
        assert x.dtype == y.dtype and x.shape == y.shape and x.device == y.device
        assert torch.equal(x, y)
    else:
        assert x == y


def test_roundtrip(store):
    t = tree()
    save_pytree(store, "ckpt", 10, t)
    out, step = restore_pytree(store, "ckpt", t)
    assert step == 10
    for a, b in zip(tree_leaves(out), tree_leaves(t)):
        _equal(a, b)


def test_atomicity_missing_manifest_ignored(store):
    t = tree()
    save_pytree(store, "ckpt", 10, t)
    save_pytree(store, "ckpt", 20, t)
    store.delete(f"ckpt/step_{20:08d}/{MANIFEST}")  # simulate torn write
    assert latest_step(store, "ckpt") == 10
    assert restore_pytree(store, "ckpt", t)[1] == 10


def test_async_save(store):
    t = tree()
    h = save_pytree(store, "ckpt", 5, t, blocking=False)
    t["a"].add_(100.0)          # the leaves were copied before the thread
    h.wait()
    assert h.done() and latest_step(store, "ckpt") == 5
    out, _ = restore_pytree(store, "ckpt", t)
    assert torch.equal(out["a"], torch.arange(12, dtype=torch.float32).reshape(3, 4))


def test_manager_retention(store):
    mgr = CheckpointManager(store, "run1", save_interval_steps=10, keep_n=2)
    t = tree()
    for s in (10, 20, 30, 40):
        mgr.save(s, t, blocking=True)
    mgr.wait()
    assert steps(store, "run1") == [30, 40]
    assert not any("step_00000010" in k for k in store.list("run1/"))
    assert mgr.saves == 4 and not mgr.should_save(0) and mgr.should_save(20)


def test_deadline_model(tmp_path):
    inner = LocalObjectStore(str(tmp_path / "s3b"))
    slow = ThrottledStore(inner, bandwidth_bps=1e6, latency_s=0.0, simulate=True)
    mgr = CheckpointManager(slow, "run", keep_n=1)
    small = {"a": torch.zeros((10,), dtype=torch.float32)}
    big = {"a": torch.zeros((200_000_000 // 4,), dtype=torch.float32, device="meta")}
    assert mgr.fits_deadline(small, deadline_s=120.0)
    assert not mgr.fits_deadline(big, deadline_s=120.0)
    assert tree_bytes(big) == 200_000_000
    assert tree_bytes({"step": 3, "m": [torch.zeros(2, dtype=torch.bfloat16)]}) == 8
    mgr.save(1, small, blocking=True)
    manifest = inner.get(f"run/step_{1:08d}/{MANIFEST}")
    assert slow.simulated_time == pytest.approx((40 + len(manifest)) / 1e6)


def test_placement_hook(store):
    """sharding_fn receives each template leaf and names its device."""
    t = tree()
    save_pytree(store, "ckpt", 1, t)
    calls = []

    def place(leaf):
        calls.append(tuple(leaf.shape))
        return torch.device("cpu")

    out, _ = restore_pytree(store, "ckpt", t, sharding_fn=place)
    assert calls == [(3, 4), (2, 2)]
    assert all(x.device.type == "cpu" for x in tree_leaves(out))


def test_manager_restore_specific_step(store):
    mgr = CheckpointManager(store, "run2", save_interval_steps=10, keep_n=3)
    for s in (10, 20, 30):
        mgr.save(s, {"a": torch.full((4,), float(s))}, blocking=True)
    like = {"a": torch.zeros((4,))}
    out, got = mgr.restore(like, step=20)
    assert got == 20 and torch.equal(out["a"], torch.full((4,), 20.0))
    out, got = mgr.restore(like)              # step=None -> latest
    assert got == 30
    assert mgr.restore_latest(like)[1] == 30
    with pytest.raises(ValueError, match="leaves"):
        mgr.restore({"a": like["a"], "b": like["a"]})


def test_full_train_state_round_trips(tmp_path):
    """Params, AdamW moments, master copy and the step: bit-identical, and
    the metric stream reloads from the manifest."""
    cfg = get_config("qwen1.5-0.5b", reduced=True)
    store = LocalObjectStore(str(tmp_path / "s3m"))
    tr = Trainer(cfg, batch=2, seq=16, seed=0, device="cpu", val_every=2,
                 ckpt=CheckpointManager(store, "trialX", 10 ** 9))
    tr.run_steps(5)
    tr.save(blocking=True)
    tr2 = Trainer(cfg, batch=2, seq=16, seed=1, device="cpu", val_every=2,
                  ckpt=CheckpointManager(store, "trialX", 10 ** 9))
    assert tr2.restore() == 5 and tr2.step == 5
    for a, b in zip(tree_leaves(tr.state), tree_leaves(tr2.state)):
        _equal(a, b)
    assert tr2.state["opt"]["step"] == 5
    assert tr2.metrics_steps == tr.metrics_steps == [2, 4]
    assert tr2.metrics_vals == tr.metrics_vals


def test_trainer_checkpoint_restart(tmp_path):
    """Revocation-restart determinism: restore + replay == uninterrupted."""
    cfg = get_config("zamba2-1.2b", reduced=True)
    store = LocalObjectStore(str(tmp_path / "s3c"))
    mgr = CheckpointManager(store, "trial0", save_interval_steps=4, keep_n=2)
    tr1 = Trainer(cfg, batch=2, seq=16, seed=0, ckpt=mgr, val_every=2, device="cpu")
    tr1.run_steps(4)        # saves at 4
    mgr.wait()
    tr1.run_steps(2)        # no save
    tr2 = Trainer(cfg, batch=2, seq=16, seed=0, val_every=2, device="cpu",
                  ckpt=CheckpointManager(store, "trial0", 4, 2))
    assert tr2.restore() == 4
    tr2.run_steps(2)
    assert tr2.metrics_steps == tr1.metrics_steps
    assert tr2.metrics_vals[-1] == pytest.approx(tr1.metrics_vals[-1], rel=RESTART_RTOL)


def _jax_tree(rng):
    return {"params": {"w": jnp.asarray(rng.standard_normal((3, 5)), jnp.bfloat16),
                       "b": jnp.asarray(rng.standard_normal(5), jnp.float32)},
            "opt": {"step": jnp.asarray(7, jnp.int32),
                    "m": [jnp.asarray(rng.standard_normal((2, 2)), jnp.float32),
                          jnp.asarray(rng.integers(0, 9, 4), jnp.int32)]}}


def _torch_like(jt):
    def conv(x):
        if x.shape == () and x.dtype == jnp.int32:
            return 0                                   # the port's int step
        a = np.asarray(x)
        if a.dtype.name == "bfloat16":
            return torch.zeros(a.shape, dtype=torch.bfloat16)
        return torch.zeros(a.shape, dtype=torch.from_numpy(np.zeros(0, a.dtype)).dtype)
    return jax.tree.map(conv, jt)


def test_a_jax_checkpoint_restores_leaf_for_leaf(store):
    jt = _jax_tree(np.random.default_rng(0))
    jsave(store, "jx", 3, jt)
    out, step = restore_pytree(store, "jx", _torch_like(jt))
    assert step == 3 and out["opt"]["step"] == 7
    for a, b in zip(jax.tree.leaves(jt), tree_leaves(out)):
        if isinstance(b, int):
            assert int(a) == b
            continue
        assert b.shape == a.shape
        want = np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a)
        np.testing.assert_array_equal(b.float().numpy() if b.dtype == torch.bfloat16
                                      else b.numpy(), want)


def test_a_port_checkpoint_restores_in_jax_with_the_same_manifest(store):
    jt = _jax_tree(np.random.default_rng(1))
    jsave(store, "jx", 1, jt)
    tt, _ = restore_pytree(store, "jx", _torch_like(jt))
    save_pytree(store, "pt", 1, tt, extra_meta={"k": [1, 2]})
    back, _ = jrestore(store, "pt", jt)
    for a, b in zip(jax.tree.leaves(jt), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(np.asarray(a, np.float32), np.asarray(b, np.float32))
    jm = json.loads(store.get(f"jx/step_{1:08d}/{MANIFEST}"))
    tm = json.loads(store.get(f"pt/step_{1:08d}/{MANIFEST}"))
    for key in ("treedef", "n_leaves", "step", "shapes", "dtypes", "keys"):
        assert tm[key] == jm[key], key
    assert tm["extra"] == {"k": [1, 2]}

"""The port's real-training backend (``repro_torch.backends.training``).

Part one ports ``tests/test_training_backend.py`` to the port alone, on the
CPU (``device="cpu"``): protocol conformance, HP binding, the checkpoint
lifecycle (deadline gate, restore onto a named device, stream
continuation), donor inheritance (PBT exploit, TrimTuner warm start), the
registry JSON contract and the full SpotTune loop on real trials.

Part two holds it against the JAX package: ``TRAINING_WORKLOADS`` field by
field (``model_bytes`` prices every snapshot), the recorded step-cost table
against the reference's ``_step_cost``, ``base_step_time`` bit for bit on
every pool instance, the port's own step count beside the reference's,
metric streams from the JAX package's initial state, and two replays
bitwise equal.

Tolerances, written before the first run:

* C4, the trials' bf16 losses (float32 master) against the JAX package's
  from the same initial state: 1e-2 relative on each of 8 losses.  Both
  round activations to bf16 (eps 2^-8 = 3.9e-3), but at different places:
  XLA on the CPU fuses bf16 elementwise chains and computes them in
  float32, where PyTorch rounds every op's output.  The per-element
  differences are about one bf16 ulp and average out in the mean loss
  (~1e-3 at step 1); Adam's first steps, which move each weight by about
  the learning rate whatever the gradient's size, can flip the sign of the
  update of near-zero gradient components and so carry the difference on.
* The port's own step count (``measure_step_cost``: unfused bytes) beside
  the reference's (XLA's fused HBM count): ``base_step_time`` within
  [0.4, 2.5] times the reference's on every pool instance.  Estimated
  before the count was run: unfused bytes 1-4 times XLA's, and the
  all-reduce term (exact: the parameter bytes) dampens that ratio in
  ``s0 * t(chips) / t(8 chips)`` to at most ~2.3 at 1 chip and ~0.6 at 64.
"""

import dataclasses
import json
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import _torch_port  # noqa: F401  (one intra-op thread)

from repro_torch.backends import BACKENDS, TrialBackend, make_backend
from repro_torch.backends.training import (RECORDED_STEP_COST, TRAINING_BINDINGS,
                                           TRAINING_WORKLOADS, TrainingBinding,
                                           TrainingTrialBackend, _to_host,
                                           measure_step_cost)
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.checkpointer import restore_pytree
from repro_torch.core.market import DEFAULT_POOL
from repro_torch.core.trial import SimTrialBackend, TrialSpec
from repro_torch.launch.train import Trainer
from repro_torch.optim.optimizers import tree_leaves, tree_map
from repro_torch.sweep.runner import SweepRunner
from repro_torch.sweep.spec import ScenarioSpec
from repro_torch.tuner.policies.pbt import PBTScheduler, PBTSearcher

C4_RTOL = 1e-2
C4_STEPS = 8
PORT_COST_RATIO = (0.4, 2.5)


@pytest.fixture(scope="module")
def qwen():
    """Shared backend + workload: trials amortize across tests."""
    w = TRAINING_WORKLOADS["qwen1.5-0.5b"]
    return TrainingTrialBackend(device="cpu"), w


def _leaves_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
        for x, y in zip(la, lb))


# ---------------------------------------------------------------- protocol


def test_protocol_conformance(qwen):
    be, w = qwen
    assert isinstance(be, TrialBackend)
    assert isinstance(SimTrialBackend(list(DEFAULT_POOL)), TrialBackend)
    # the sim keeps the base no-op snapshot/restore (curves carry no state);
    # the training backend overrides both: the engine's capability gate
    assert type(be).snapshot is not TrialBackend.snapshot
    assert type(be).restore is not TrialBackend.restore
    assert SimTrialBackend.snapshot is TrialBackend.snapshot
    assert SimTrialBackend.restore is TrialBackend.restore
    sim = SimTrialBackend(list(DEFAULT_POOL))
    t = TrialSpec(w, w.hp_grid()[0], 0)
    assert sim.snapshot(t, 123.0) == 123.0


def test_backend_registry_and_factory():
    assert set(BACKENDS) == {"sim", "training"}
    assert BACKENDS["sim"]["default"] and not BACKENDS["training"]["default"]
    assert isinstance(make_backend("sim"), SimTrialBackend)
    assert isinstance(make_backend("sim", device="cpu"), SimTrialBackend)
    be = make_backend("training", device="cpu")
    assert isinstance(be, TrainingTrialBackend) and be.device.type == "cpu"
    with pytest.raises(ValueError, match="unknown backend"):
        make_backend("bogus")
    if not torch.cuda.is_available():
        # the card is the default, and its absence is an error, not a move
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_backend("training")
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TrainingTrialBackend()


def test_binding_maps_hps():
    b = TrainingBinding(arch="qwen1.5-0.5b")
    kw = b.trainer_kwargs({"lr": 1e-3, "dr": 0.5, "ds": 16, "bs": 2},
                          val_every=4)
    assert kw["lr"] == 1e-3 and kw["batch"] == 2 and kw["val_every"] == 4
    assert callable(kw["lr_schedule"])          # decay declared -> schedule
    kw2 = b.trainer_kwargs({"lr": 3e-3, "dr": 1.0, "ds": 16}, val_every=4)
    assert kw2["lr_schedule"] is None and kw2["batch"] == b.batch


def test_roofline_step_times(qwen):
    be, w = qwen
    t = TrialSpec(w, w.hp_grid()[0], 0)
    ref = next(i for i in DEFAULT_POOL if i.chips == be.ref_chips)
    assert be.base_step_time(t, ref) == pytest.approx(w.s0)
    one = next(i for i in DEFAULT_POOL if i.chips == 1)
    assert be.base_step_time(t, one) > w.s0
    ticks = be.noisy_step_times(t, ref, 3, 5, 10.0)
    singles = [be.step_time(t, ref, noisy_t=k * 10.0) for k in (3, 4, 5)]
    assert list(ticks) == singles


# ------------------------------------------------------------ metric stream


def test_real_curve_matches_uninterrupted_trainer(qwen):
    be, w = qwen
    t = TrialSpec(w, w.hp_grid()[0], 0)
    stream = be.metric_range(t, 1, 4)                 # steps 4..16
    binding = be._binding(t)
    tr = Trainer(**binding.trainer_kwargs(t.hp, w.val_every), device="cpu")
    tr.run_steps(16)
    assert stream == tr.metrics_vals[:4]
    assert be.metric_at(t, w.val_every - 1) is None   # before first point
    assert be.metric_at(t, w.max_trial_steps * 10) == be.true_final(t)


def test_metric_stream_is_decreasing_on_average(qwen):
    be, w = qwen
    t = TrialSpec(w, w.hp_grid()[0], 0)
    vals = be.metric_range(t, 1, w.max_trial_steps // w.val_every)
    assert vals[-1] < vals[0]                         # it actually learns
    assert be.host_step_time(t) > 0


@pytest.mark.parametrize("data_seed", [0, 1, 2])
def test_mamba2_multi_seed_losses_finite(data_seed):
    """The reduced mamba2 preset stays finite on every data seed (the SSD
    mixer masks its log-decays before the exp)."""
    from repro_torch.configs.base import get_config
    from repro_torch.data.pipeline import SyntheticLMDataset
    from repro_torch.launch.train import batch_to, init_state, make_train_step
    from repro_torch.models.context import null_ctx
    from repro_torch.models.model import Model
    from repro_torch.optim import adamw

    cfg = get_config("mamba2-130m", reduced=True)
    model = Model(cfg)
    opt = adamw(3e-3, keep_master=(cfg.opt_precision == "fp32"))
    state = init_state(model, opt, 0, device="cpu")
    ds = SyntheticLMDataset(cfg, 4, 32, seed=data_seed)
    step = make_train_step(model, opt, null_ctx(attn_chunk=32, remat="none"))
    for i in range(12):
        state, metrics = step(state, batch_to(ds.get_batch(i), "cpu"))
        assert np.isfinite(float(metrics["loss"])), \
            f"non-finite loss at step {i} (data seed {data_seed})"
    assert all(bool(torch.isfinite(x.float()).all())
               for x in tree_leaves(state["params"]))


def test_mamba2_binding_uses_default_data_seed():
    assert TRAINING_BINDINGS[TRAINING_WORKLOADS["mamba2-130m"].name].seed == 0


# ------------------------------------------------------- checkpoint lifecycle


def test_snapshot_restore_onto_a_named_device_bit_identical(qwen):
    _, w = qwen
    be = TrainingTrialBackend(device="cpu",
                              sharding_fn=lambda tmpl: torch.device("cpu"))
    t = TrialSpec(w, w.hp_grid()[0], 0)
    assert be.snapshot(t, 8, deadline_s=120.0) == 8.0
    be.restore(t, 8)
    key, step, restored = be.last_restore
    assert (key, step) == (t.key, 8)
    run = be._run(t)
    # bit-identical full state: params, AdamW moments, the master, the step
    assert _leaves_equal(restored, be._host_state(run, 8))
    like = be._to_device(run.state0)
    tree, got = restore_pytree(be.store, run.prefix, like, step=8,
                               sharding_fn=lambda tmpl: torch.device("cpu"))
    assert got == 8 and tree["opt"]["step"] == 8
    assert all(leaf.device.type == "cpu" for leaf in tree_leaves(tree["params"]))


def test_restored_stream_continues_exactly(qwen):
    be, w = qwen
    t = TrialSpec(w, w.hp_grid()[0], 0)
    be.snapshot(t, 8, deadline_s=120.0)
    run = be._run(t)
    binding = be._binding(t)
    mgr = CheckpointManager(be.store, run.prefix, save_interval_steps=10 ** 9,
                            keep_n=0)
    tr = Trainer(**binding.trainer_kwargs(t.hp, w.val_every), ckpt=mgr,
                 device="cpu")
    assert tr.restore(step=8) == 8
    # manifest metadata rebuilt the stream up to the snapshot...
    assert tr.metrics_vals == be.metric_range(t, 1, 2)
    tr.run_steps(8)
    # ...and the continuation reproduces the uninterrupted stream exactly
    assert tr.metrics_vals == be.metric_range(t, 1, 4)


def test_fits_deadline_gates_snapshot(qwen):
    _, w = qwen
    be = TrainingTrialBackend(bandwidth_bps=1e3, device="cpu")   # ~1 KB/s
    t = TrialSpec(w, w.hp_grid()[0], 0)
    assert be.snapshot(t, 8, deadline_s=120.0) == 0.0
    assert be.snapshot_skips == 1 and be.snapshots == 0
    assert be.snapshot(t, 8, deadline_s=1e9) == 8.0
    assert be.snapshot(t, 16, deadline_s=120.0) == 8.0
    assert be.snapshot_skips == 2 and be.snapshots == 1


def test_engine_notice_budget_honored(qwen):
    be, w = qwen
    t = TrialSpec(w, w.hp_grid()[0], 0)
    assert be.store.transfer_time(int(w.model_bytes)) < 120.0
    assert be.checkpoint_time(t, 999.0) == pytest.approx(
        be.store.transfer_time(int(w.model_bytes)))   # engine knob ignored


# --------------------------------------------------------- donor inheritance


def test_inherited_trial_starts_from_donor_state(qwen):
    be, w = qwen
    donor = TrialSpec(w, w.hp_grid()[0], 0)
    be.metric_at(donor, 8)                            # materialize donor run
    child = TrialSpec(w, w.hp_grid()[3], 3, inherit=(donor.key, 8))
    run = be._run(child)
    donor_state = be._host_state(be._run(donor), 8)
    assert _leaves_equal(run.state0, donor_state)     # params + opt moments
    fresh = be._run(TrialSpec(w, w.hp_grid()[3], 3))
    assert not _leaves_equal(fresh.state0, donor_state)


def test_pbt_exploit_resumes_from_donor_checkpoint(qwen):
    be, w = qwen
    sched = PBTScheduler(population=4, seed=0)
    searcher = PBTSearcher(w, population=4, resample_prob=0.0, seed=0)
    searcher.bind_scheduler(sched)
    members = [searcher.suggest() for _ in range(4)]
    for m in members:
        sched.on_trial_added(m)
    m0 = sched.milestones[0]
    for rank, m in enumerate(members):
        sched._results[0][m.key] = 1.0 + rank
        sched._ms_idx[m.key] = 1
    donors = sched.exploit_donors()
    assert donors[0][0] == members[0].key and donors[0][2] == m0
    assert len(donors) == 3                           # bottom quartile cut
    repl = searcher.suggest()
    assert repl is not None and repl.inherit is not None
    dkey, dstep = repl.inherit
    assert dstep == m0 and dkey in {m.key for m in members[:3]}
    donor_spec = next(m for m in members if m.key == dkey)
    be.metric_at(donor_spec, dstep)
    run = be._run(repl)
    assert _leaves_equal(run.state0,
                         be._host_state(be._run(donor_spec), dstep))


def test_trimtuner_warm_start_declares_inherit():
    from repro_torch.tuner.policies.trimtuner import TrimTunerSearcher

    w = TRAINING_WORKLOADS["qwen1.5-0.5b"]
    s = TrimTunerSearcher(w, initial=4, batch=2, seed=0)
    boot = [s.suggest() for _ in range(4)]
    assert all(b.inherit is None for b in boot)       # bootstrap: fresh

    class _View:
        def __init__(self, spec, metric, steps):
            self.spec = spec
            self.metrics_vals = [metric]
            self.steps = steps
            self.billed_cost = 1.0

    for j, b in enumerate(boot):
        s.on_trial_finished(_View(b, 5.0 + j, 21))
    donor_hp = boot[0].hp
    near = next(i for i, hp in enumerate(s.grid)
                if sum(hp[k] != donor_hp[k] for k in hp) == 1)
    far = next(i for i, hp in enumerate(s.grid)
               if sum(hp[k] != donor_hp[k] for k in hp) > 1)
    assert s._warm_start(near) == (boot[0].key, 20)
    assert s._warm_start(far) is None
    assert s.suggest() is not None                    # refinement wave runs


# -------------------------------------------------- registry + spec contract


def test_registry_describe_json():
    from repro.tuner.registry import describe_json as jdescribe
    from repro_torch.tuner.registry import describe_json
    info = describe_json()
    assert set(info["backends"]) == {"sim", "training"}
    assert info["backends"]["training"]["spaces"] == ["grid"]
    assert "qwen1.5-0.5b" in info["backends"]["training"]["workloads"]
    assert info["searchers"]["pbt"]["supports_continuous"]
    assert not info["searchers"]["trimtuner"]["supports_continuous"]
    assert info["policy_defaults"]["pbt"]["searcher"] == "pbt"
    # the JAX package's, but for the module paths
    ref = jdescribe()
    for name, meta in info["backends"].items():
        want = dict(ref["backends"][name])
        assert want.pop("module").replace("repro.", "repro_torch.") == meta["module"]
        assert {k: v for k, v in meta.items() if k != "module"} == want


def test_registry_json_cli():
    import os
    import pathlib
    env = dict(os.environ)
    env["PYTHONPATH"] = str(pathlib.Path(__file__).resolve().parents[1] / "src")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.tuner.registry", "--json"],
        capture_output=True, text=True, check=True, env=env, timeout=120)
    info = json.loads(out.stdout)
    assert "backends" in info and "schedulers" in info
    assert info["backends"]["training"]["module"] == "repro_torch.backends.training"


def test_spec_validation_rejects_bad_combos():
    ok = ScenarioSpec(workload="qwen1.5-0.5b", market_seed=0,
                      backend="training")
    ok.validate()
    with pytest.raises(ValueError, match="unknown backend"):
        ScenarioSpec(workload="LoR", market_seed=0,
                     backend="bogus").validate()
    with pytest.raises(ValueError, match="ground-truths spaces"):
        ScenarioSpec(workload="qwen1.5-0.5b", market_seed=0,
                     backend="training", space="continuous").validate()
    with pytest.raises(ValueError, match="binds workloads"):
        ScenarioSpec(workload="LoR", market_seed=0,
                     backend="training").validate()
    with pytest.raises(ValueError, match="unknown searcher"):
        ScenarioSpec(workload="LoR", market_seed=0,
                     searcher="bogus").validate()
    with pytest.raises(ValueError, match="finite spaces only"):
        ScenarioSpec(workload="LoR", market_seed=0, space="continuous",
                     searcher="grid").validate()
    assert (ScenarioSpec(workload="train-qwen1.5-0.5b", market_seed=0,
                         backend="training").workload_obj()
            is ok.workload_obj())
    with pytest.raises(ValueError, match="no training binding"):
        ScenarioSpec(workload="LoR", market_seed=0,
                     backend="training").workload_obj()


def test_spec_messages_match_the_reference():
    from repro.sweep.spec import ScenarioSpec as JSpec
    cases = [dict(workload="LoR", market_seed=0, backend="training"),
             dict(workload="qwen1.5-0.5b", market_seed=0, backend="training",
                  space="continuous"),
             dict(workload="LoR", market_seed=0, backend="bogus",
                  scheduler="nope"),
             dict(workload="whisper-base", market_seed=3, backend="training")]
    for kw in cases:
        assert ScenarioSpec(**kw).validation_errors() == JSpec(**kw).validation_errors()
    with pytest.raises(ValueError) as want:
        JSpec(workload="LoR", market_seed=0, backend="training").workload_obj()
    with pytest.raises(ValueError) as got:
        ScenarioSpec(workload="LoR", market_seed=0, backend="training").workload_obj()
    assert str(got.value) == str(want.value)


# ------------------------------------------------------------- full loop


def test_training_scenario_full_spottune_loop():
    """Acceptance: a backend="training" sweep runs the whole SpotTune loop:
    θ provisioning, real revocation checkpoint/restore through
    repro_torch.checkpoint, EarlyCurve fit on the real loss stream,
    alongside a sim replica sharing the same runner."""
    sim = ScenarioSpec(workload="LoR", market_seed=0, days=2.0)
    train = ScenarioSpec(workload="qwen1.5-0.5b", market_seed=0,
                         backend="training", days=2.0)
    runner = SweepRunner(device="cpu")
    tuners = runner.prepare([sim, train])
    assert isinstance(tuners[0].engine.backend, SimTrialBackend)
    be = tuners[1].engine.backend
    assert isinstance(be, TrainingTrialBackend) and be.device.type == "cpu"
    res_sim = tuners[0].run()
    res = tuners[1].run()
    assert res_sim.steps_total > 0
    assert res.steps_total > 0 and res.redeployments > 0
    assert be.snapshots > 0 and be.restores > 0
    assert be.store.inner.bytes_written > 0
    assert res.refunded > 0
    grid = tuners[1].engine.views()
    assert len(res.predicted_rank) == len(list(grid)) == 8
    assert res.predicted_rank[0].startswith("train-qwen1.5-0.5b/")


def test_sweep_runner_hands_its_device_to_the_training_backend():
    from repro_torch.sweep.soa import soa_supported
    specs = [ScenarioSpec(workload="LoR", market_seed=0, days=2.0),
             ScenarioSpec(workload="mamba2-130m", market_seed=0,
                          backend="training", days=2.0)]
    tuners = SweepRunner(device="cpu").prepare(specs)
    assert tuners[1].engine.backend.device.type == "cpu"
    # training replicas take the round-robin generator path, not SoA rounds
    assert soa_supported(tuners[:1]) and not soa_supported(tuners)


# ====================================================== against the JAX package


def test_training_workloads_equal_the_references():
    from repro.backends.training import TRAINING_BINDINGS as JB
    from repro.backends.training import TRAINING_WORKLOADS as JW
    assert list(TRAINING_WORKLOADS) == list(JW)
    for arch, w in TRAINING_WORKLOADS.items():
        assert dataclasses.asdict(w) == dataclasses.asdict(JW[arch]), arch
    assert {w.name: w.model_bytes for w in TRAINING_WORKLOADS.values()} == {
        "train-qwen1.5-0.5b": 2332932.0, "train-mamba2-130m": 1019524.0,
        "train-whisper-base": 3721476.0}
    assert {k: dataclasses.asdict(b) for k, b in TRAINING_BINDINGS.items()} == {
        k: dataclasses.asdict(b) for k, b in JB.items()}


SEED_BINDINGS = sorted(RECORDED_STEP_COST)


@pytest.mark.parametrize("key", SEED_BINDINGS, ids=lambda k: f"{k[0]}-bs{k[2]}")
def test_recorded_step_cost_is_the_references(key):
    from repro.backends.training import TrainingBinding as JBinding
    from repro.backends.training import _step_cost
    arch, reduced, bs, seq = key
    assert _step_cost(JBinding(arch=arch, reduced=reduced, seq=seq), bs) \
        == RECORDED_STEP_COST[key]


@pytest.mark.parametrize("key", SEED_BINDINGS, ids=lambda k: f"{k[0]}-bs{k[2]}")
def test_base_step_time_bit_equal_on_every_instance(key):
    from repro.backends.training import TRAINING_WORKLOADS as JW
    from repro.backends.training import TrainingTrialBackend as JBackend
    from repro.core.trial import TrialSpec as JSpec
    arch, _, bs, _ = key
    w = TRAINING_WORKLOADS[arch]
    hp = next(h for h in w.hp_grid() if h["bs"] == bs)
    jbe, be = JBackend(), TrainingTrialBackend(device="cpu")
    for inst in DEFAULT_POOL:
        want = jbe.base_step_time(JSpec(JW[arch], hp, 0), inst)
        assert be.base_step_time(TrialSpec(w, hp, 0), inst) == want, inst.name


def test_port_step_count_beside_the_references():
    """The port's own count (used for any binding the table lacks) priced
    through the same roofline: its ``base_step_time`` on every instance of
    the pool beside the recorded count's, for the six seed bindings."""
    from repro_torch.backends.training import _roofline_seconds
    ratios = {}
    for key in SEED_BINDINGS:
        arch, reduced, bs, seq = key
        binding = TrainingBinding(arch=arch, reduced=reduced, seq=seq)
        port = measure_step_cost(binding, bs)
        ref = RECORDED_STEP_COST[key]
        assert port[2] == ref[2]                  # the parameters' bytes
        for inst in DEFAULT_POOL:
            t = [_roofline_seconds(*c, inst.chips) / _roofline_seconds(*c, 8)
                 for c in (port, ref)]
            ratios[(arch, bs, inst.name)] = t[0] / t[1]
    lo, hi = PORT_COST_RATIO
    bad = {k: r for k, r in ratios.items() if not lo <= r <= hi}
    assert not bad, bad
    # the count never replaces a recorded entry
    be = TrainingTrialBackend(device="cpu")
    w = TRAINING_WORKLOADS["qwen1.5-0.5b"]
    from repro_torch.backends.training import _COST_CACHE, _step_cost
    assert _step_cost(TRAINING_BINDINGS[w.name], 4) == RECORDED_STEP_COST[
        ("qwen1.5-0.5b", True, 4, 32)]
    assert ("qwen1.5-0.5b", True, 4, 32) not in _COST_CACHE
    # ...and a binding outside the table is counted by the port
    other = TrainingBinding(arch="qwen1.5-0.5b", seq=16)
    be.bindings["train-qwen1.5-0.5b"] = other
    t = TrialSpec(w, w.hp_grid()[0], 0)
    assert be.base_step_time(t, DEFAULT_POOL[0]) > 0
    assert _COST_CACHE[("qwen1.5-0.5b", True, 4, 16)] == measure_step_cost(other, 4)


def _jax_state_as_port(jstate):
    """The JAX package's training state as the port's: tensors of the same
    shapes and types, the step a Python int."""
    from repro_torch.models.model import _to_tensor
    out = tree_map(lambda a: _to_tensor(a, "cpu"), jax.tree.map(np.asarray, jstate))
    out["opt"]["step"] = int(jstate["opt"]["step"])
    return out


@pytest.mark.parametrize("arch", list(TRAINING_WORKLOADS))
def test_bf16_streams_from_the_references_initial_state(arch):
    """C4: the trial's own config (bf16, float32 master) through the port's
    Trainer and the JAX package's, from the JAX package's initial state."""
    from repro.backends.training import TRAINING_BINDINGS as JB
    from repro.launch.train import Trainer as JTrainer
    name = TRAINING_WORKLOADS[arch].name
    jkw = JB[name].trainer_kwargs({"lr": 3e-3}, 1)
    jt = JTrainer(**jkw)
    tt = Trainer(**TRAINING_BINDINGS[name].trainer_kwargs({"lr": 3e-3}, 1),
                 device="cpu")
    assert jkw["cfg"].dtype == tt.cfg.dtype == "bfloat16"
    tt.state = _jax_state_as_port(jt.state)
    assert _leaves_equal(tt.state, _jax_state_as_port(jt.state))
    jt.run_steps(C4_STEPS)
    tt.run_steps(C4_STEPS)
    rel = np.abs(np.subtract(tt.metrics_vals, jt.metrics_vals)) / np.abs(jt.metrics_vals)
    assert np.isfinite(tt.metrics_vals).all()
    assert rel.max() <= C4_RTOL, (tt.metrics_vals, jt.metrics_vals, rel)


@pytest.mark.parametrize("arch", list(TRAINING_WORKLOADS))
def test_replay_is_bitwise(arch):
    """C5 on the CPU: the replayer's state at a mid step equals the
    cursor's at that step on every leaf, and two replays equal each
    other."""
    w = TRAINING_WORKLOADS[arch]
    be = TrainingTrialBackend(device="cpu")
    t = TrialSpec(w, w.hp_grid()[0], 0)
    run = be._run(t)
    be._ensure(run, 6)
    at6 = _to_host(run.trainer.state)
    be._ensure(run, 12)
    assert run.trainer.step == 12 and 6 not in run.hostcache
    first = be._host_state(run, 6)                   # replayed from state0
    assert run.replayer.step == 6
    run.replayer = None
    second = be._host_state(run, 6)
    assert _leaves_equal(first, at6) and _leaves_equal(second, at6)

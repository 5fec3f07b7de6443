"""Shared helpers for the tests that hold the PyTorch port (``repro_torch``)
against the JAX package (``repro``): plain-data views of run outcomes, so
the two packages' enums and event classes are compared by name, never by
identity, and RevPreds of both packages built from the same JAX weights."""

import enum

import jax
import numpy as np
import torch

# The port's tensors in these tests are tiny: one intra-op thread runs them
# several times faster than a pool of them, and keeps the test workers from
# oversubscribing the host's cores.
torch.set_num_threads(1)


def plain(x):
    """Enums -> names, deferred billing records -> dicts, containers
    recursively; everything else as it is."""
    if isinstance(x, enum.Enum):
        return x.name
    if hasattr(x, "record") and hasattr(x, "row"):
        return dict(x.record())
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(plain(v) for v in x)
    return x


def run_outcome(engine, res):
    """Everything ``repro.tuner.equivalence.compare_engines`` compares, as
    plain data."""
    return {
        "billed": engine.market.billed,
        "refunded": engine.market.refunded,
        "t": engine.t,
        "trials": {s.key: (s.status.name, s.finish_time, s.redeployments,
                           list(s.metrics_steps), list(s.metrics_vals),
                           s.steps, s.free_steps, s.lost_steps,
                           s.ckpt_seconds, s.restore_seconds)
                   for s in engine.states},
        "events": plain(list(engine.events)),
        "predicted_rank": list(res.predicted_rank),
        "jct": res.jct,
    }


def jax_revpred_params(market, hidden=32):
    """Per-market JAX-initialized RevPred weights as numpy pytrees."""
    from repro.core.market import stable_hash
    from repro.core.revpred import init_revpred
    return {i.name: jax.tree.map(
        np.asarray, init_revpred(jax.random.key(stable_hash(i.name) & 0x7FFFFFFF),
                                 hidden))
            for i in market.pool}


def jax_revpred(market, params, pos_frac=0.2):
    from repro.core.revpred import RevPred, TrainedPredictor, revpred_logits
    return RevPred(market, {
        n: TrainedPredictor(revpred_logits, jax.tree.map(jax.numpy.asarray, p),
                            pos_frac, True)
        for n, p in params.items()})


def torch_revpred(market, params, pos_frac=0.2, device="cpu"):
    from repro_torch.core.revpred import (RevPred, TrainedPredictor,
                                          params_from_numpy, revpred_logits)
    return RevPred(market, {
        n: TrainedPredictor(revpred_logits, params_from_numpy(p, device),
                            pos_frac, True, device=device)
        for n, p in params.items()}, device=device)

"""RevPred: spot-revocation-probability prediction (paper §III-B), PyTorch.

Given (instance market I, maximum price b, timestamp t): probability that the
market price exceeds b within the next hour.

Model (faithful to the paper):
  * history branch: the past 59 one-minute records, 6 engineered features
    each -> 3-layer LSTM -> last hidden state;
  * present branch: the current record (6 features + max price) -> 3
    sequential FC layers;
  * concat -> FC -> logit.

The feature engineering, dataset construction, Eq. 3 de-skew and the oracle
are numpy and carry over from the JAX package unchanged.  The forwards are
PyTorch over a leading group dimension G: every parameter leaf carries one
row per group (``jax.vmap`` written out), and each LSTM step of each layer is
one call of the fused cell (``kernels.ops.lstm_cell``), whatever G is.  The
parameter layout is the JAX package's: ``w_ih`` (I, 4H), ``w_hh`` (H, 4H),
gate order i, f, g, o; ``params_from_numpy`` carries its weights across.

``predict_pool_multi`` is the sweep's cross-replica batch point: the cache
misses of every request, across markets and replicas, go through one grouped
forward.  Training (``train_model``, ``RevPred.train``) is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import numpy as np
import torch

from repro_torch.core.market import MINUTE, InstanceType, SpotMarket
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops

HISTORY = 59
N_FEAT = 6


# ---------------------------------------------------------------------------
# feature engineering
# ---------------------------------------------------------------------------


def _window_sum(csum: np.ndarray, window: int = 60) -> np.ndarray:
    """out[t] = csum[t] - csum[t-window] (0 before the window fills) —
    the trailing-window sum given a cumulative sum, fully vectorized."""
    out = csum.copy()
    out[window:] = csum[window:] - csum[:-window]
    return out


def trace_features(trace: np.ndarray, od_price: float) -> np.ndarray:
    """Per-minute feature matrix (T, 6), prices normalized by on-demand.

    All trailing-window features come from sliding-window cumulative sums
    (the per-minute Python loops here used to dominate RevPred training
    set-up on 12-day traces)."""
    T = len(trace)
    f = np.zeros((T, N_FEAT), np.float32)
    p = trace / od_price
    f[:, 0] = p
    csum = np.cumsum(p)
    n = np.minimum(np.arange(T), 59) + 1          # trailing-window lengths
    f[:, 1] = _window_sum(csum) / n.astype(csum.dtype)
    changes = np.concatenate([[0.0], (np.diff(trace) != 0).astype(np.float32)])
    cch = np.cumsum(changes)
    # minutes since the price was last set: t - (index of the last change)
    idx = np.arange(T)
    last_change = np.maximum.accumulate(np.where(changes > 0, idx, 0))
    dur = (idx - last_change).astype(np.float32)
    f[:, 2] = _window_sum(cch) / 60.0
    f[:, 3] = np.minimum(dur, 240.0) / 240.0
    day = idx // 1440
    f[:, 4] = (day % 7 < 5).astype(np.float32)
    f[:, 5] = ((idx % 1440) / 60.0) / 24.0
    return f


def algorithm2_delta(trace: np.ndarray, t: int) -> float:
    """Paper Algorithm 2: 20 %-trimmed mean of |Δprice| over the last hour."""
    lo = max(1, t - 59)
    deltas = np.abs(np.diff(trace[lo - 1 : t + 1]))
    if len(deltas) == 0:
        return 0.0
    deltas = np.sort(deltas)
    L = len(deltas)
    lo_i, hi_i = int(0.2 * L), int(0.8 * L)
    core = deltas[lo_i:hi_i] if hi_i > lo_i else deltas
    return float(np.mean(core))


def algorithm2_deltas(trace: np.ndarray, ts: np.ndarray) -> np.ndarray:
    """Vectorized ``algorithm2_delta`` for many timestamps: one sliding-window
    view over |Δprice|, one row-wise sort, one trimmed row mean."""
    ts = np.asarray(ts)
    if len(ts) == 0:
        return np.zeros(0)
    if np.any(ts < 60):          # partial trailing windows -> scalar path
        return np.array([algorithm2_delta(trace, int(t)) for t in ts])
    absdiff = np.abs(np.diff(trace))
    # window for t covers diffs lo-1 .. t-1 with lo = t-59 -> 60 entries
    wins = np.lib.stride_tricks.sliding_window_view(absdiff, 60)[ts - 60]
    core = np.sort(wins, axis=1)[:, 12:48]       # int(.2*60), int(.8*60)
    return np.mean(core, axis=1)


def label_revoked(trace: np.ndarray, t: int, max_price: float) -> bool:
    """True iff the market exceeds max_price within the next hour."""
    fut = trace[t + 1 : t + 61]
    return bool(np.any(fut > max_price))


def build_dataset(trace: np.ndarray, od_price: float, t_lo: int, t_hi: int,
                  mode: str, rng: np.random.Generator, stride: int = 3):
    """-> dict(hist (N,59,6), present (N,7), label (N,)).

    mode='algo2' (RevPred) or 'random' (Tributary) controls the max-price
    delta used for *training* labels; evaluation always uses random deltas
    (paper: inference samples deltas like Tributary does).

    Deviation noted in DESIGN.md: 'algo2' mixes 50% Algorithm-2 border
    samples with 50% random-delta samples.  On traces with long flat holds
    the trimmed-mean delta collapses to ~0 and pure border sampling yields
    a single-class training set; the mix keeps the active-learning border
    points while spanning the delta distribution.

    Fully vectorized: windows come from a sliding view over the feature
    matrix, labels from a rolling next-hour price maximum, and the random
    deltas from one batched draw (numpy Generators fill arrays from the same
    stream scalar calls consume, so the samples match the old per-row loop).
    """
    feats = trace_features(trace, od_price)
    ts = np.arange(max(t_lo, HISTORY + 1), t_hi - 61, stride)
    n = len(ts)
    deltas = np.empty(n, np.float64)
    # the paper's absolute U[1e-5, 0.2] interval assumes sub-dollar markets
    # (r3.xlarge od=$0.33); scale to this market's price level
    scale = od_price / 0.33
    if mode == "algo2":
        deltas[0::2] = algorithm2_deltas(trace, ts[0::2])
        deltas[1::2] = rng.uniform(0.00001, 0.2, size=len(ts[1::2])) * scale
    else:
        deltas[:] = rng.uniform(0.00001, 0.2, size=n) * scale
    b = trace[ts].astype(np.float64) + deltas
    # hist: feature rows t-59..t-1 for each sample
    hist = np.lib.stride_tricks.sliding_window_view(
        feats, HISTORY, axis=0)[ts - HISTORY].transpose(0, 2, 1)
    present = np.concatenate(
        [feats[ts], (b / od_price)[:, None].astype(np.float32)], axis=1)
    # revoked within the next hour <=> rolling max of the next 60 minutes
    # exceeds the max price (compared in float32, like the scalar labeler)
    fut_max = np.lib.stride_tricks.sliding_window_view(
        trace, 60)[ts + 1].max(axis=1)
    return {
        "hist": np.ascontiguousarray(hist).astype(np.float32),
        "present": present.astype(np.float32),
        "label": (fut_max > b.astype(trace.dtype)).astype(np.float32),
    }


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


def tree_map(fn: Callable, *trees):
    """``fn`` over the leaves of parameter trees (nested dicts and lists)."""
    t0 = trees[0]
    if isinstance(t0, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in t0}
    if isinstance(t0, (list, tuple)):
        return [tree_map(fn, *xs) for xs in zip(*trees)]
    return fn(*trees)


def params_from_numpy(tree, device="cuda"):
    """A JAX parameter pytree, as nested dicts and lists of numpy arrays
    (``jax.tree.map(np.asarray, params)``), as tensors on ``device`` in the
    same layout and dtype."""
    dev = resolve_device(device)
    return tree_map(lambda a: torch.from_numpy(np.array(a)).to(dev), tree)


def dense_init(generator: torch.Generator, in_dim: int, out_dim: int):
    """Truncated-normal fan-in init: N(0, 1) cut at +-2, times 1/sqrt(in_dim)
    (the JAX package's ``models.layers.dense_init``), drawn on the CPU."""
    w = torch.empty(in_dim, out_dim, dtype=torch.float32)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return w * (1.0 / np.sqrt(in_dim))


def _init_lstm_stack(generator, in_dim: int, hidden: int, n_layers: int):
    ls = []
    for i in range(n_layers):
        d = in_dim if i == 0 else hidden
        ls.append({"w_ih": dense_init(generator, d, 4 * hidden),
                   "w_hh": dense_init(generator, hidden, 4 * hidden),
                   "b": torch.zeros(4 * hidden)})
    return ls


def init_revpred(generator: torch.Generator, hidden: int = 32, device="cuda"):
    """Fresh RevPred parameters (ungrouped, the JAX package's layout)."""
    dev = resolve_device(device)
    f = N_FEAT
    params = {
        "lstm": _init_lstm_stack(generator, f, hidden, 3),
        "fc1": {"w": dense_init(generator, f + 1, hidden), "b": torch.zeros(hidden)},
        "fc2": {"w": dense_init(generator, hidden, hidden), "b": torch.zeros(hidden)},
        "fc3": {"w": dense_init(generator, hidden, hidden), "b": torch.zeros(hidden)},
        "head": {"w": dense_init(generator, 2 * hidden, 1), "b": torch.zeros(1)},
    }
    return tree_map(lambda t: t.to(dev), params)


# ---------------------------------------------------------------------------
# grouped forwards: params leaves (G, ...); hist (G,B,T,F); present (G,B,7)
# ---------------------------------------------------------------------------


def _run_lstm_stack(params, seq, force=None):
    """seq (G, B, T, I) -> final hidden (G, B, H) of the top layer; one fused
    cell call per step per layer."""
    G, B = seq.shape[:2]
    xs = seq.permute(2, 0, 1, 3).contiguous()        # time-major (T, G, B, I)
    for lp in params:
        hdim = lp["w_hh"].shape[-2]
        h = torch.zeros(G, B, hdim, dtype=seq.dtype, device=seq.device)
        c = torch.zeros_like(h)
        hs = []
        for t in range(xs.shape[0]):
            h, c = kops.lstm_cell(xs[t], h, c, lp["w_ih"], lp["w_hh"], lp["b"],
                                  force=force)
            hs.append(h)
        xs = torch.stack(hs)
    return h


def _dense(x, p):
    """x (G,B,D) @ w (G,D,O) + b (G,O)."""
    return torch.bmm(x, p["w"]) + p["b"][:, None, :]


def revpred_logits(params, hist, present, force=None):
    """hist (G,B,59,6); present (G,B,7) -> logits (G,B)."""
    he = _run_lstm_stack(params["lstm"], hist, force)
    pe = present
    for k in ("fc1", "fc2", "fc3"):
        pe = torch.relu(_dense(pe, params[k]))
    z = torch.cat([he, pe], dim=-1)
    return _dense(z, params["head"])[..., 0]


def tributary_logits(params, hist, present, force=None):
    """Tributary-style baseline: everything through the LSTM."""
    G, B = hist.shape[:2]
    hist7 = torch.cat([hist, hist.new_zeros(G, B, HISTORY, 1)], dim=-1)
    seq = torch.cat([hist7, present[:, :, None, :]], dim=2)   # (G, B, 60, 7)
    h = _run_lstm_stack(params["lstm"], seq, force)
    return _dense(h, params["head"])[..., 0]


def logreg_logits(params, hist, present, force=None):
    """present (G,B,7) . w (G,7) + b (G,)."""
    return torch.bmm(present, params["w"][:, :, None])[..., 0] + params["b"][:, None]


# ---------------------------------------------------------------------------
# calibrated inference (Eq. 3)
# ---------------------------------------------------------------------------


def eq3_correct(p_hat, pos_frac: float):
    """Odds de-skewing: P/(1-P) = P̂·φ₋ / ((1-P̂)·φ₊)."""
    phi_p = max(pos_frac, 1e-6)
    phi_n = max(1.0 - pos_frac, 1e-6)
    odds = (p_hat * phi_n) / torch.clamp((1.0 - p_hat) * phi_p, min=1e-9)
    return odds / (1.0 + odds)


def _grouped(params):
    """Ungrouped params as a group of one."""
    return tree_map(lambda t: t[None], params)


@dataclasses.dataclass
class TrainedPredictor:
    """Per-market predictor bundle with Eq. 3 calibration.  ``params`` are
    ungrouped (the JAX package's layout) and are moved to ``device``."""
    logit_fn: Callable
    params: dict
    pos_frac: float
    use_eq3: bool = True
    device: str = "cuda"

    def __post_init__(self):
        dev = resolve_device(self.device)
        self.device = str(dev)
        self.params = tree_map(lambda t: t.to(dev), self.params)

    @torch.inference_mode()
    def predict(self, hist: np.ndarray, present: np.ndarray) -> np.ndarray:
        dev = torch.device(self.device)
        lg = self.logit_fn(_grouped(self.params),
                           torch.as_tensor(hist).to(dev)[None],
                           torch.as_tensor(present).to(dev)[None])[0]
        p = torch.sigmoid(lg)
        if self.use_eq3:
            p = eq3_correct(p, self.pos_frac)
        return p.cpu().numpy()


class RevPred:
    """Market-level interface used by the Provisioner.

    One TrainedPredictor per instance market; ``predict(inst, t, max_price)``
    memoizes per minute, and ``predict_pool`` answers several markets in one
    grouped forward on ``device``.
    """

    def __init__(self, market: SpotMarket, predictors: Dict[str, TrainedPredictor],
                 device="cuda"):
        self.market = market
        self.predictors = predictors
        self.device = resolve_device(device)
        self._feat_cache: Dict[str, np.ndarray] = {}
        self._p_cache: Dict = {}
        self._stack = None      # lazily-built batched-inference bundle

    def _features(self, inst: InstanceType) -> np.ndarray:
        if inst.name not in self._feat_cache:
            self._feat_cache[inst.name] = trace_features(
                self.market.traces[inst.name], inst.od_price)
        return self._feat_cache[inst.name]

    def predict(self, inst: InstanceType, t: float, max_price: float) -> float:
        minute = int(t / MINUTE)
        key = (inst.name, minute, round(max_price, 5))
        if key in self._p_cache:
            return self._p_cache[key]
        hist, present = self._sample(inst, minute, max_price)
        p = float(self.predictors[inst.name].predict(hist[None],
                                                     present[None])[0])
        self._p_cache[key] = p
        return p

    def _sample(self, inst: InstanceType, minute: int, max_price: float):
        feats = self._features(inst)
        m = min(max(minute, HISTORY), len(feats) - 1)
        hist = feats[m - HISTORY : m]
        present = np.concatenate(
            [feats[m], [max_price / inst.od_price]]).astype(np.float32)
        return hist, present

    def _ensure_stack(self):
        """Stack per-market params along a group dimension for one grouped
        forward over the pool.  Returns None when the predictors are
        heterogeneous (mixed model kinds/widths) — callers then fall back to
        per-market dispatch."""
        if self._stack is None:
            preds = [self.predictors.get(i.name) for i in self.market.pool]
            fns = {id(p.logit_fn) for p in preds if p is not None}
            if None in preds or len(fns) != 1:
                self._stack = False
            else:
                try:
                    stacked = tree_map(
                        lambda *xs: torch.stack([x.to(self.device) for x in xs]),
                        *[p.params for p in preds])
                except (RuntimeError, TypeError, ValueError):
                    self._stack = False
                else:
                    self._stack = {
                        "row": {i.name: r for r, i
                                in enumerate(self.market.pool)},
                        "params": stacked,
                        "fn": preds[0].logit_fn,
                        "pos_frac": np.array([p.pos_frac for p in preds]),
                        "use_eq3": np.array([p.use_eq3 for p in preds]),
                    }
        return self._stack or None

    def predict_pool(self, insts, t: float, max_prices) -> list:
        """Revocation probabilities for several markets at one timestamp in a
        single grouped forward — the Provisioner calls this once per
        deployment instead of one batch-1 forward per pool entry."""
        minute = int(t / MINUTE)
        out = [None] * len(insts)
        misses = []
        for i, (inst, mp) in enumerate(zip(insts, max_prices)):
            key = (inst.name, minute, round(mp, 5))
            p = self._p_cache.get(key)
            if p is None:
                misses.append((i, inst, mp, key))
            else:
                out[i] = p
        if not misses:
            return out
        stack = self._ensure_stack()
        if stack is None:
            for i, inst, mp, key in misses:
                out[i] = self.predict(inst, t, mp)
            return out
        samples = [self._sample(inst, minute, mp) for _, inst, mp, _ in misses]
        hist = np.stack([h for h, _ in samples])
        present = np.stack([pr for _, pr in samples])
        rows = np.array([stack["row"][inst.name] for _, inst, mp, _ in misses])
        idx = torch.as_tensor(rows, device=self.device)
        params = tree_map(lambda x: x.index_select(0, idx), stack["params"])
        p = _stacked_forward(stack["fn"], params, hist, present, self.device)
        # Eq. 3 odds de-skew, elementwise with per-market pos_frac
        p = _eq3_deskew(p, stack["pos_frac"][rows], stack["use_eq3"][rows])
        for (i, _, _, key), pi in zip(misses, p):
            out[i] = self._p_cache[key] = float(pi)
        return out


@torch.inference_mode()
def _stacked_forward(fn: Callable, params, hist: np.ndarray,
                     present: np.ndarray, device) -> np.ndarray:
    """One batch-1 forward per group row -> p: a float32 sigmoid, then
    float64 (as the JAX package's vmapped forward returns it).  The sigmoid
    runs on the host in float64 and rounds to float32, so a row's answer
    does not depend on where it sits in the batch (PyTorch's CPU sigmoid
    computes the elements past the last full vector another way)."""
    lg = fn(params, torch.as_tensor(hist).to(device)[:, None],
            torch.as_tensor(present).to(device)[:, None])
    lg = lg.float().cpu().numpy()[:, 0].astype(np.float64)
    return (1.0 / (1.0 + np.exp(-lg))).astype(np.float32).astype(np.float64)


def _eq3_deskew(p: np.ndarray, pos_frac: np.ndarray,
                use_eq3: np.ndarray) -> np.ndarray:
    """Vectorized Eq. 3 odds de-skew with per-row pos_frac, applied only
    where ``use_eq3`` — the single implementation both the per-market and
    the cross-replica batch paths share (their answers must stay
    bit-identical)."""
    phi_p = np.maximum(pos_frac, 1e-6)
    phi_n = np.maximum(1.0 - pos_frac, 1e-6)
    odds = (p * phi_n) / np.maximum((1.0 - p) * phi_p, 1e-9)
    return np.where(use_eq3, odds / (1.0 + odds), p)


def _leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def predict_pool_multi(requests) -> list:
    """Revocation probabilities for many ``(revpred, insts, t, max_prices)``
    requests — the sweep runtime's cross-replica batch point.

    All cache misses of every ``RevPred`` request sharing one model
    architecture (and device) are answered by a single grouped forward:
    each request's stacked per-market parameters are picked with
    ``index_select`` and the picks concatenated along the group dimension,
    across *markets and replicas*.  Each group row's arithmetic reads only
    its own parameters, so the answers equal per-replica ``predict_pool``
    calls.  Non-``RevPred`` predictors (oracle, zero, custom) fall back to
    their own path."""
    out = [None] * len(requests)
    mixed: Dict[tuple, list] = {}     # (fn, leaf shapes, device) -> misses
    for ri, (rp, insts, t, mps) in enumerate(requests):
        if not isinstance(rp, RevPred):
            pool = getattr(rp, "predict_pool", None)
            out[ri] = (pool(insts, t, mps) if pool is not None else
                       [rp.predict(inst, t, mp)
                        for inst, mp in zip(insts, mps)])
            continue
        minute = int(t / MINUTE)
        row = [None] * len(insts)
        misses = []
        for i, (inst, mp) in enumerate(zip(insts, mps)):
            key = (inst.name, minute, round(mp, 5))
            p = rp._p_cache.get(key)
            if p is None:
                misses.append((i, inst, mp, key))
            else:
                row[i] = p
        out[ri] = row
        if not misses:
            continue
        stack = rp._ensure_stack()
        if stack is None:
            for i, inst, mp, key in misses:
                row[i] = rp.predict(inst, t, mp)
            continue
        # group by model fn, per-market param shapes and device: only
        # same-width stacks on one device can share one concatenated forward
        sig = tuple((tuple(leaf.shape[1:]), str(leaf.dtype))
                    for leaf in _leaves(stack["params"]))
        fid = (id(stack["fn"]), sig, str(rp.device))
        mixed.setdefault(fid, []).append((ri, rp, stack, minute, misses))
    for group in mixed.values():
        hists, presents, trees, pfs, eq3s = [], [], [], [], []
        device, fn = group[0][1].device, group[0][2]["fn"]
        for ri, rp, stack, minute, misses in group:
            rows = np.array([stack["row"][inst.name]
                             for _, inst, _, _ in misses])
            idx = torch.as_tensor(rows, device=device)
            trees.append(tree_map(lambda x: x.index_select(0, idx),
                                  stack["params"]))
            for _, inst, mp, _ in misses:
                h, pr = rp._sample(inst, minute, mp)
                hists.append(h)
                presents.append(pr)
            pfs.append(stack["pos_frac"][rows])
            eq3s.append(stack["use_eq3"][rows])
        params = tree_map(lambda *xs: torch.cat(xs), *trees)
        p = _stacked_forward(fn, params, np.stack(hists),
                             np.stack(presents), device)
        p = _eq3_deskew(p, np.concatenate(pfs), np.concatenate(eq3s))
        pos = 0
        for ri, rp, stack, minute, misses in group:
            for i, _, _, key in misses:
                out[ri][i] = rp._p_cache[key] = float(p[pos])
                pos += 1
    return out


def _sliding_max(arr: np.ndarray, w: int) -> np.ndarray:
    """out[i] = max(arr[i:i+w]) in O(n): block prefix/suffix running maxima
    (float max is exact and order-free, so this matches the windowed scan
    bit-for-bit at a 60th of the work)."""
    n = len(arr)
    if n < w:
        return np.empty(0, arr.dtype)
    nout = n - w + 1
    nb = (n + w - 1) // w
    pad = np.full(nb * w, -np.inf, arr.dtype)
    pad[:n] = arr
    blocks = pad.reshape(nb, w)
    suff = np.maximum.accumulate(blocks[:, ::-1], axis=1)[:, ::-1].ravel()
    pref = np.maximum.accumulate(blocks, axis=1).ravel()
    return np.maximum(suff[:nout], pref[w - 1:w - 1 + nout])


# rolling next-hour maxima keyed by trace identity: every oracle over the
# same (memoized, frozen) trace shares one build — a sweep's replicas pay
# the index once per market seed instead of once per replica.  Bounded FIFO
# so un-memoized traces (CSV replays) don't pin entries forever.
_FUT_MAX_CACHE: Dict[int, tuple] = {}
_FM_LIST_CACHE: Dict[int, tuple] = {}   # same maxima as plain lists
_FUT_MAX_CACHE_MAX = 512


def clear_prediction_caches() -> None:
    """Drop shared prediction indices (cold-start benchmarking)."""
    _FUT_MAX_CACHE.clear()
    _FM_LIST_CACHE.clear()


class OracleRevPred:
    """Upper-bound predictor that reads the future from the simulator —
    used in ablations to bound how much predictor quality can matter.

    Caches each market's rolling next-hour price maximum (shared across
    replicas of the same trace), so a prediction is one float comparison
    instead of a 60-minute scan (the oracle sits on the fig7–9 deployment
    hot path)."""

    def __init__(self, market: SpotMarket):
        self.market = market
        self._fm_rows = None       # pool-aligned (fm list, len) pairs
        self._fm_minute: dict = {}  # minute -> pool-aligned fm row (array)

    def _future_max(self, name: str) -> np.ndarray:
        trace = self.market.traces[name]
        hit = _FUT_MAX_CACHE.get(id(trace))
        if hit is not None and hit[0] is trace:
            return hit[1]
        # fm[t] = max(trace[t+1 : t+61]) for every full next-hour window
        fm = _sliding_max(trace, 60)[1:]
        if len(_FUT_MAX_CACHE) >= _FUT_MAX_CACHE_MAX:
            _FUT_MAX_CACHE.pop(next(iter(_FUT_MAX_CACHE)))
        _FUT_MAX_CACHE[id(trace)] = (trace, fm)
        return fm

    def predict(self, inst: InstanceType, t: float, max_price: float) -> float:
        trace = self.market.traces[inst.name]
        m = int(t / MINUTE)
        fm = self._future_max(inst.name)
        if m < len(fm):
            return 1.0 if fm[m] > max_price else 0.0
        return 1.0 if label_revoked(trace, m, max_price) else 0.0

    def pool_label_fm(self, name: str) -> tuple:
        """(rolling next-hour maxima as a plain float list, length) for one
        market — the trace-keyed shared cache entry (identical float64
        values to ``_future_max``); replicas of one market seed share it."""
        trace = self.market.traces[name]
        ent = _FM_LIST_CACHE.get(id(trace))
        if ent is None or ent[0] is not trace:
            fm = self._future_max(name)
            if len(_FM_LIST_CACHE) >= _FUT_MAX_CACHE_MAX:
                _FM_LIST_CACHE.pop(next(iter(_FM_LIST_CACHE)))
            ent = (trace, fm.tolist(), len(fm))
            _FM_LIST_CACHE[id(trace)] = ent
        return ent[1], ent[2]

    def pool_fm_rows(self) -> list:
        """``pool_label_fm`` for every pool member, aligned with
        ``market.pool`` — built once per predictor (traces are immutable
        for a market's lifetime)."""
        ent = self._fm_rows
        if ent is None:
            ent = self._fm_rows = [self.pool_label_fm(i.name)
                                   for i in self.market.pool]
        return ent

    def pool_fm_minute(self, minute: int) -> np.ndarray:
        """Pool-aligned next-hour-max row for one minute (NaN past a trace's
        fm horizon — callers fall back to ``predict`` there).  Memoized per
        minute so the cross-replica fused deploy solve indexes one array
        instead of rebuilding the row per deploy window."""
        ent = self._fm_minute.get(minute)
        if ent is None:
            ent = self._fm_minute[minute] = np.array(
                [fml[minute] if minute < L else np.nan
                 for fml, L in self.pool_fm_rows()])
        return ent

    def predict_pool_pairs(self, cands, t: float) -> list:
        """``predict`` over one drawn candidate list without per-call array
        indexing: a few dict gets and float compares per pool member via
        ``pool_label_fm``."""
        m = int(t / MINUTE)
        out = []
        for inst, mp in cands:
            fml, L = self.pool_label_fm(inst.name)
            out.append((1.0 if fml[m] > mp else 0.0) if m < L
                       else self.predict(inst, t, mp))
        return out

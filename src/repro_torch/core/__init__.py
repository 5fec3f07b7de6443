"""SpotTune core, ported: the market simulator, the simulated trials, the
Eq. 1-2 provisioner, RevPred inference and EarlyCurve.

market        transient-resource market simulator (prices, revocation, refund)
trial         HP grids + simulated workload suite (paper Table II)
provisioner   Eq. 1-2 expected step cost, argmin instance selection
revpred       LSTM revocation-probability predictor: inference and
              training (the LSTM stack runs as CUDA kernels on the card)
earlycurve    staged training-trend prediction, and the single-stage SLAQ
              baseline of Fig. 11
orchestrator  the legacy Orchestrator / build_spottune layer over the tuner

Drive it through ``repro_torch.tuner``::

    engine = build_engine(market, SimTrialBackend(market.pool), revpred)
    result = Tuner(engine, SpotTuneScheduler(theta=0.7, mcnt=3),
                   GridSearcher(workload)).run()
"""

from repro_torch.core.earlycurve import EarlyCurve, SLAQPredictor  # noqa: F401
from repro_torch.core.market import DEFAULT_POOL, InstanceType, SpotMarket  # noqa: F401
from repro_torch.core.provisioner import PerfModel, Provisioner, ZeroRevPred  # noqa: F401
from repro_torch.core.revpred import OracleRevPred, RevPred, TrainedPredictor  # noqa: F401
from repro_torch.core.trial import WORKLOADS, SimTrialBackend, TrialSpec, make_trials  # noqa: F401

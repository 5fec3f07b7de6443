"""The simulated instance pool's roofline rates.

The tuner bills trials on a simulated pool of TPU v5e slices
(``core.market.DEFAULT_POOL``), kept identical to the JAX package's for
parity.  A training trial's virtual seconds a step come from these per-chip
rates of that simulated pool (``backends.training._roofline_seconds``), as
the JAX package's ``launch.roofline`` constants give them.  They are data
of the simulation: no rate of the card the port runs on.  The rest of the
JAX package's ``launch.roofline`` (the dry-run analysis) is not ported.
"""

#: simulated pool, per chip: peak bf16 FLOP/s
PEAK_FLOPS = 197e12
#: simulated pool, per chip: HBM bytes/s
HBM_BW = 819e9
#: simulated pool, per link: interconnect bytes/s
LINK_BW = 50e9

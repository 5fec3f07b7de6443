"""Launchers: ``serve`` (batched greedy decoding), ``train`` (the train
step and ``Trainer`` with checkpoint/restart) and ``roofline`` (the
simulated pool's rates, constants only); the rest of the JAX package's
``launch`` (dry-run, meshes, sharding, the HLO cost walk) is not ported
yet."""

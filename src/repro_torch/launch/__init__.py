"""Launchers: ``serve`` (batched greedy decoding) and ``train`` (the train
step and ``Trainer`` with checkpoint/restart); the rest of the JAX
package's ``launch`` (dry-run, meshes, sharding) is not ported yet."""

"""Launchers: ``serve`` (batched greedy decoding) for now; the rest of the
JAX package's ``launch`` (train, dry-run, meshes) is not ported yet."""

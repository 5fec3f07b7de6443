"""Checkpointing of parameter trees through an object store (the port of
``repro.checkpoint``): the same on-store layout, so either package reads
what the other wrote."""

from repro_torch.checkpoint.object_store import LocalObjectStore, ThrottledStore  # noqa: F401
from repro_torch.checkpoint.checkpointer import (  # noqa: F401
    CheckpointManager,
    latest_step,
    restore_pytree,
    save_pytree,
)

"""Input pipelines: deterministic synthetic LM batches and threaded
prefetch (the port of ``repro.data``)."""

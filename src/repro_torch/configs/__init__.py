"""Model configurations: the JAX package's ``configs`` data, copied as it is.

``base`` holds ``ModelConfig``, ``ShapeSpec``, ``ARCH_IDS``, ``registry()`` and
``get_config()``; each ``<arch>.py`` exports ``CONFIG`` (the published shape)
and ``REDUCED`` (the same family, tiny, for CPU tests).
"""

"""The model stack in PyTorch: layers, attention (on the
``flash_attention`` kernel), Mamba2 SSD (on the ``ssd_chunk`` kernel),
mixture-of-experts (``moe``), latent attention (``mla``), blocks and
``Model`` for every family of the JAX package (dense, vlm, moe, ssm,
hybrid, audio), serving and training.  Parameters keep the JAX package's pytree
layout (nested dicts, layer stacks along a leading L axis), so
``model.params_from_numpy`` carries its weights across."""

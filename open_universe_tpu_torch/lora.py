"""The reference's ``open_universe.lora`` names (JAX package ``lora.py``):
``inject`` adds adapters, ``remove`` folds them back, and
``freeze_parameters_except_lora_and_bias`` leaves ``requires_grad`` on the
adapters and the biases only (``nn/lora.py``)."""
from .nn.lora import inject, remove, set_trainable  # noqa: F401

freeze_parameters_except_lora_and_bias = set_trainable

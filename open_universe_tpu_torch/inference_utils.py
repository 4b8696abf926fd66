"""Alias of the reference's ``open_universe.inference_utils``."""
from .inference.model_loader import ckpt_to_config_path, load_model  # noqa: F401
from .inference.signature_to_parser import add_enhance_arguments  # noqa: F401

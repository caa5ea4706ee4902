from .files import load_json, load_yaml, save_json, save_yaml
from .utils import elapsed_timer, get_rank, is_main_process, seed_everything
from .weights import (
    load_flax_npz, strip_torch_prefixes, torch_key_for, variables_from_torch, variables_to_torch,
)

__all__ = ["elapsed_timer", "get_rank", "is_main_process", "load_flax_npz", "load_json",
           "load_yaml", "save_json", "save_yaml", "seed_everything", "strip_torch_prefixes",
           "torch_key_for", "variables_from_torch", "variables_to_torch"]

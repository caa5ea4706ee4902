from .argv import parse_flags
from .export import export_program, export_weights_npz
from .files import load_json, load_yaml, save_json, save_yaml
from .model_info import count_params, model_cost, param_table
from .utils import elapsed_timer, get_rank, is_main_process, seed_everything
from .weights import (
    flax_path_for, load_flax_npz, load_torchvision_backbone, resnet_variables_from_torchvision,
    strip_torch_prefixes, torch_key_for, variables_from_state_dict, variables_from_torch,
    variables_to_torch,
)

__all__ = ["count_params", "elapsed_timer", "export_program", "export_weights_npz",
           "flax_path_for", "get_rank", "is_main_process", "load_flax_npz", "load_json",
           "load_torchvision_backbone", "load_yaml", "model_cost", "param_table", "parse_flags",
           "resnet_variables_from_torchvision", "save_json", "save_yaml",
           "seed_everything", "strip_torch_prefixes", "torch_key_for", "variables_from_state_dict",
           "variables_from_torch", "variables_to_torch"]

from .weights import load_flax_npz, strip_torch_prefixes, torch_key_for, variables_to_torch

__all__ = ["load_flax_npz", "strip_torch_prefixes", "torch_key_for", "variables_to_torch"]

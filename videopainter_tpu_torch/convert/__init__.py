from .from_jax import (branch_state_dict, captured_state, i3d_state_dict, load_quantized,
                       lora_params, lpips_state_dict, sam2_state_dict, transformer_state_dict,
                       vae_state_dict)
from .safetensors_io import load_safetensors_dir, save_safetensors_dir

__all__ = ["branch_state_dict", "captured_state", "i3d_state_dict", "load_quantized",
           "lora_params", "lpips_state_dict", "sam2_state_dict",
           "transformer_state_dict", "vae_state_dict", "load_safetensors_dir",
           "save_safetensors_dir"]

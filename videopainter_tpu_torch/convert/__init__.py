from .from_jax import (branch_state_dict, captured_state, load_quantized, lora_params,
                       transformer_state_dict, vae_state_dict)

__all__ = ["branch_state_dict", "captured_state", "load_quantized", "lora_params",
           "transformer_state_dict", "vae_state_dict"]

"""T5-XXL prompt encoding (the reference's text tower).

Counterpart of `videopainter_tpu/models/text_encoder.py`: the T5 tokenizer
pads to 226 tokens (`padding="max_length"`, truncation, special tokens), the
encoder runs on the ids alone (no attention mask, as the reference's
`_get_t5_prompt_embeds`), and the (usually empty) negative prompt takes a
pass of its own. The text tower is transformers' torch `T5EncoderModel`, a
library model on both sides (the JAX package runs `FlaxT5EncoderModel`), so
it has no hand-written kernel. Pipelines take precomputed `prompt_embeds`
as well; `load_prompt_embeds` reads them from a file.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import numpy as np
import torch

from .. import resolve_device


class T5TextEncoder:
    """A tokenizer and a T5 encoder; `encode` returns [1, max_length, d_model]
    on the encoder's device."""

    def __init__(self, tokenizer, model, max_length: int = 226):
        self.tokenizer = tokenizer
        self.model = model
        self.max_length = max_length

    @classmethod
    def from_local(cls, path: str, max_length: int = 226, dtype=torch.bfloat16,
                   device: Optional[Union[str, torch.device]] = "cuda") -> "T5TextEncoder":
        """Tokenizer and encoder from a local directory (a CogVideoX
        `text_encoder/` with its tokenizer files); nothing is downloaded."""
        from transformers import AutoTokenizer, T5EncoderModel

        dev = resolve_device(device)
        tokenizer = AutoTokenizer.from_pretrained(path, local_files_only=True)
        model = T5EncoderModel.from_pretrained(path, torch_dtype=dtype, local_files_only=True)
        return cls(tokenizer, model.to(dev).eval(), max_length)

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def encode(self, prompt: Optional[str], max_length: Optional[int] = None) -> torch.Tensor:
        """[1, max_length, d_model] embeddings of `prompt` (None reads as "")."""
        max_length = max_length or self.max_length
        ids = self.tokenizer(prompt or "", padding="max_length", max_length=max_length,
                             truncation=True, add_special_tokens=True, return_tensors="np")
        ids = torch.as_tensor(np.asarray(ids["input_ids"]), dtype=torch.long, device=self.device)
        with torch.inference_mode():
            hidden = self.model(input_ids=ids).last_hidden_state
        # an inference tensor cannot be saved for a backward pass (the
        # training step projects the embeddings with trainable weights)
        return hidden.clone()

    def encode_with_negative(self, prompt: Optional[str], negative_prompt: str = ""
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.encode(prompt), self.encode(negative_prompt)


def load_prompt_embeds(path: str) -> torch.Tensor:
    """Precomputed embeddings from an .npz (its first array) or .npy file,
    [S, D] or [1, S, D]; returns [1, S, D]."""
    arr = np.load(path)
    if hasattr(arr, "files"):
        arr = arr[arr.files[0]]
    if arr.ndim == 2:
        arr = arr[None]
    return torch.from_numpy(np.ascontiguousarray(arr))

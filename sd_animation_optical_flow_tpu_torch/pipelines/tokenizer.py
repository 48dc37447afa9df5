"""Prompt tokenization for the CLIP conditioning stage.

A copy of ``sd_animation_optical_flow_tpu/pipelines/tokenizer.py`` (the
port imports nothing from the JAX package), hash fallback included.

The reference uses the HF CLIPTokenizer through transformers
(reference: ldm/modules/encoders/modules.py:95-99) with the chunked
encoding applied in hack.py:32-70. Here:

  * if the HF tokenizer vocab is available locally (cache or path), use
    it (exact token parity with the reference);
  * otherwise fall back to a deterministic hash tokenizer so pipelines
    remain runnable in weightless/offline environments (documented
    non-parity mode — conditioning is random-feature but stable).
"""

from __future__ import annotations

import hashlib
import re
from typing import List, Optional

from ..models.clip import chunk_token_ids


class PromptTokenizer:
    def __init__(self, vocab_size: int = 49408,
                 hf_name_or_path: Optional[str] = "openai/clip-vit-large-patch14"):
        self.vocab_size = vocab_size
        self._hf = None
        if hf_name_or_path is not None:
            try:
                from transformers import CLIPTokenizer
                self._hf = CLIPTokenizer.from_pretrained(
                    hf_name_or_path, local_files_only=True)
            except Exception:
                self._hf = None

    @property
    def exact(self) -> bool:
        """True when real CLIP BPE is in use."""
        return self._hf is not None

    def raw_ids(self, text: str) -> List[int]:
        """Token ids WITHOUT special tokens (hack.py tokenize(),
        add_special_tokens=False). Underscores are spaced out first
        (hack.py:37)."""
        text = text.replace("_", " ")
        if self._hf is not None:
            return self._hf(text, truncation=False,
                            add_special_tokens=False)["input_ids"]
        # fallback: word-level deterministic hashing into the vocab range,
        # avoiding the special-token ids at the top of the range
        words = re.findall(r"[a-zA-Z0-9']+|[^\sa-zA-Z0-9]", text.lower())
        ids = []
        for w in words:
            h = int(hashlib.sha1(w.encode()).hexdigest(), 16)
            ids.append(h % (self.vocab_size - 3) + 1)
        return ids

    def chunked(self, text: str):
        """-> [3, 77] int32 (BOS/EOS/PAD wrapped, hack.py contract)."""
        return chunk_token_ids(self.raw_ids(text))

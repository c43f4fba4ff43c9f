"""Tokenizer: GPT-2 byte-level BPE with an ``<|image|>`` special token.

Parity target: reference magma/utils.py:43-58 — GPT2TokenizerFast with
pad = eos, right padding, model_max_length = LM seq len, and ``<|image|>``
registered as the cls token (so ``image_token_id == 50257`` and
``len(tokenizer) == 50258``).

A copy of ``magma_tpu/tokenizer.py``.  Differences from the reference:
returns numpy int32 arrays (host-side; the device copy happens at the
model boundary), and works fully offline.  When GPT-2
vocab/merges files are unavailable (air-gapped environments), a byte-level
fallback tokenizer provides the identical id-space contract (eos=50256,
image=50257, len=50258) so model shapes, checkpoints, and tests match
production exactly; only the text<->id mapping differs.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import List, Optional, Sequence, Union

import numpy as np

GPT2_VOCAB_SIZE = 50257  # byte-level BPE + <|endoftext|>
GPT2_EOS_ID = 50256
IMAGE_TOKEN = "<|image|>"


class MagmaTokenizer:
    """Common interface for all tokenizer backends."""

    eos_token_id: int = GPT2_EOS_ID
    image_token_id: int = GPT2_VOCAB_SIZE  # appended special token (50257)
    model_max_length: int = 2048
    padding_side: str = "right"

    # `cls_token_id` / `pad_token_id` aliases for reference-API parity
    # (magma/magma.py:48 reads tokenizer.cls_token_id for the image token).
    @property
    def cls_token_id(self) -> int:
        return self.image_token_id

    @property
    def pad_token_id(self) -> int:
        return self.eos_token_id

    def __len__(self) -> int:
        return self.image_token_id + 1  # 50258

    # -- abstract --------------------------------------------------------
    def _encode_text(self, text: str) -> List[int]:
        raise NotImplementedError

    def _decode_ids(self, ids: Sequence[int]) -> str:
        raise NotImplementedError

    # -- shared ----------------------------------------------------------
    def encode(
        self,
        text: str,
        max_length: Optional[int] = None,
        padding: Optional[str] = None,
        truncation: bool = False,
    ) -> np.ndarray:
        """Encode text to a (1, s) int32 array.

        With ``padding="max_length"`` the row is right-padded with eos to
        ``max_length`` (matching dataset.py:136-142 in the reference, where
        pad token == eos).
        """
        ids = self._encode_text(text)
        if truncation and max_length is not None:
            ids = ids[:max_length]
        if padding == "max_length" and max_length is not None:
            ids = ids + [self.eos_token_id] * (max_length - len(ids))
        return np.asarray([ids], dtype=np.int32)

    def decode(self, ids: Union[Sequence[int], np.ndarray]) -> str:
        ids = [int(i) for i in np.asarray(ids).reshape(-1)]
        # strip special tokens (image / eos) like the reference decode path
        # (magma/sampling.py:33-40 removes image and eos tokens first).
        # image_token_id is always the last real id, so `< image_token_id`
        # also drops MXU vocab-padding ids — and stays correct for
        # miniature test vocabs where the ids aren't 50256/50257.
        ids = [
            i for i in ids
            if i < self.image_token_id and i != self.eos_token_id
        ]
        return self._decode_ids(ids)

    def batch_decode(self, batch: Union[np.ndarray, Sequence[Sequence[int]]]) -> List[str]:
        return [self.decode(row) for row in batch]


class GPT2BPETokenizer(MagmaTokenizer):
    """Real GPT-2 byte-level BPE via the HF `tokenizers` Rust backend.

    Loads from explicit vocab.json/merges.txt paths (fully offline).
    """

    def __init__(self, vocab_file: str, merges_file: str, sequence_length: int = 2048):
        from tokenizers import ByteLevelBPETokenizer  # rust, offline

        self._tok = ByteLevelBPETokenizer(vocab_file, merges_file)
        self._tok.add_special_tokens(["<|endoftext|>", IMAGE_TOKEN])
        self.model_max_length = sequence_length
        self.image_token_id = self._tok.token_to_id(IMAGE_TOKEN)
        self.eos_token_id = self._tok.token_to_id("<|endoftext|>")

    def _encode_text(self, text: str) -> List[int]:
        return self._tok.encode(text).ids

    def _decode_ids(self, ids: Sequence[int]) -> str:
        return self._tok.decode(list(ids))


class ByteFallbackTokenizer(MagmaTokenizer):
    """Offline fallback: UTF-8 bytes map to ids 0..255.

    Keeps the production id-space contract (eos=50256, image=50257,
    len=50258) so every shape in the framework matches the GPT-2 setup.
    Used automatically when no GPT-2 vocab files can be found; fine for
    tests, benchmarks, and synthetic training.
    """

    def __init__(self, sequence_length: int = 2048):
        self.model_max_length = sequence_length

    def _encode_text(self, text: str) -> List[int]:
        return list(text.encode("utf-8"))

    def _decode_ids(self, ids: Sequence[int]) -> str:
        return bytes(i for i in ids if 0 <= i < 256).decode("utf-8", errors="replace")


def _find_gpt2_files() -> Optional[tuple]:
    """Look for gpt2 vocab.json + merges.txt in common local locations."""
    candidates = [
        os.environ.get("MAGMA_TPU_GPT2_DIR"),
        str(Path.home() / ".cache" / "magma_tpu" / "gpt2"),
        str(Path(__file__).resolve().parents[1] / "assets" / "gpt2"),
    ]
    for d in candidates:
        if d is None:
            continue
        vocab, merges = Path(d) / "vocab.json", Path(d) / "merges.txt"
        if vocab.exists() and merges.exists():
            return str(vocab), str(merges)
    return None


def _byte_fallback(sequence_length: int, strict: bool) -> MagmaTokenizer:
    """The byte fallback keeps every SHAPE correct while producing
    garbage TEXT on real prompts — in a deployment that must never
    engage silently (the reference always runs real GPT-2 BPE,
    magma/utils.py:43-58)."""
    msg = (
        "No GPT-2 BPE assets found — falling back to the byte-level "
        "tokenizer (correct id space, WRONG text mapping for real "
        "prompts).  Point MAGMA_TPU_GPT2_DIR at a directory containing "
        "vocab.json + merges.txt (or pass vocab_file/merges_file) for "
        "production text."
    )
    if strict:
        raise FileNotFoundError(msg)
    import warnings

    warnings.warn(msg, RuntimeWarning, stacklevel=3)
    return ByteFallbackTokenizer(sequence_length)


def get_tokenizer(
    name: str = "gpt2",
    sequence_length: int = 2048,
    vocab_file: Optional[str] = None,
    merges_file: Optional[str] = None,
    strict: bool = False,
) -> MagmaTokenizer:
    """Get the LM tokenizer.  Parity: reference magma/utils.py:43-58.

    Resolution order: explicit files -> local gpt2 assets
    (``MAGMA_TPU_GPT2_DIR``, ``~/.cache/magma_tpu/gpt2``) -> HF-cached
    GPT2TokenizerFast (offline mode) -> byte-level fallback (warns; with
    ``strict=True`` raises instead — set it in production so garbage
    text can never ship with perfect shapes).
    """
    if name != "gpt2":
        raise ValueError(f"Tokenizer {name} not recognized")

    if vocab_file and merges_file:
        return GPT2BPETokenizer(vocab_file, merges_file, sequence_length)

    found = _find_gpt2_files()
    if found:
        return GPT2BPETokenizer(found[0], found[1], sequence_length)

    # Try the HF cache without touching the network.  Only attempt when a
    # cached snapshot actually exists — transformers' resolution path can
    # stall for minutes on air-gapped hosts otherwise.
    hf_home = Path(os.environ.get("HF_HOME", Path.home() / ".cache" / "huggingface"))
    if not (hf_home / "hub" / "models--gpt2").exists():
        return _byte_fallback(sequence_length, strict)
    os.environ.setdefault("HF_HUB_OFFLINE", "1")
    os.environ.setdefault("TRANSFORMERS_OFFLINE", "1")
    try:
        from transformers import GPT2TokenizerFast

        hf = GPT2TokenizerFast.from_pretrained("gpt2")
        hf.add_special_tokens({"cls_token": IMAGE_TOKEN})

        class _HFAdapter(MagmaTokenizer):
            def __init__(self):
                self.model_max_length = sequence_length
                self.image_token_id = hf.cls_token_id
                self.eos_token_id = hf.eos_token_id

            def _encode_text(self, text: str) -> List[int]:
                return hf.encode(text)

            def _decode_ids(self, ids: Sequence[int]) -> str:
                return hf.decode(list(ids))

        return _HFAdapter()
    except Exception:
        pass

    return _byte_fallback(sequence_length, strict)

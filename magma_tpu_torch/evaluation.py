"""Evaluation: caption loss, caption sampling, VQA-style accuracy.

Port of ``magma_tpu/evaluation.py`` (the reference's ``vqa_dir`` /
``gqa_dir`` knobs, configs/MAGMA_v2.yml:30-31, and its answers table,
utils.py:248-253, with the code behind them):

* ``eval_loss``: the mean caption loss over random batches (the chunked
  loss of ``Magma.loss_fn``: the (b, s, vocab) logits never exist),
* ``eval_captions``: captions sampled for n images in one batched call,
* ``eval_vqa``: open-ended QA over a dataset in the standard layout whose
  jsons carry ``metadata.question`` and ``metadata.answers``; prompts
  "Q: {q} A:", greedy decoding, accuracy min(#matching annotators / 3, 1)
  over normalised answers.  Questions run in batches: prompts right-padded
  with EOS and decoded with per-row prompt lengths (a ragged batch, each
  row's tokens those of its own generation).
"""

from __future__ import annotations

import re
import string
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

_ARTICLES = {"a", "an", "the"}
_PUNCT = str.maketrans("", "", string.punctuation)


def normalize_answer(text: str) -> str:
    """VQA normalisation: lowercase, no punctuation, articles or extra
    whitespace."""
    text = text.lower().strip().translate(_PUNCT)
    return " ".join(w for w in text.split() if w not in _ARTICLES)


def vqa_accuracy(prediction: str, answers: Sequence[str]) -> float:
    """min(#annotators agreeing / 3, 1) over normalised answers."""
    pred = normalize_answer(prediction)
    if not pred:
        return 0.0
    return min(sum(normalize_answer(a) == pred for a in answers) / 3.0, 1.0)


def _images_on(model, images) -> torch.Tensor:
    """Transformed images (numpy or tensors, each (1, 3, H, W)) -> one
    float32 batch on the model's device."""
    return torch.cat([torch.as_tensor(x, device=model.device).float() for x in images])


@torch.no_grad()
def eval_loss(model, dataset, n_batches: int = 25, batch_size: int = 8, seed: int = 0) -> float:
    """Mean caption loss over ``n_batches`` random batches of the dataset
    (indices from numpy's ``RandomState(seed)``, as in the JAX package)."""
    from magma_tpu_torch.data.dataset import collate_fn

    rng = np.random.RandomState(seed)
    losses = []
    for _ in range(n_batches):
        idxs = rng.randint(0, len(dataset), batch_size)
        images, captions = collate_fn([dataset[i] for i in idxs], seq_len=model.seq_len)
        loss, _ = model.loss_fn(model.params, model.state,
                                torch.as_tensor(images, device=model.device),
                                torch.as_tensor(captions, device=model.device).long(),
                                train=False)
        losses.append(loss)
    return float(torch.stack(losses).float().mean())


def eval_captions(model, dataset, n_samples: int = 4, max_steps: int = 30,
                  temperature: float = 0.7, top_p: float = 0.9, seed: int = 0) -> List[Dict]:
    """Captions sampled for ``n_samples`` images in one batched generate
    call; returns [{pred, refs}]."""
    rng = np.random.RandomState(seed)
    idxs = [int(i) for i in rng.randint(0, len(dataset), n_samples)]
    emb = model.embed([_images_on(model, [dataset[i][0] for i in idxs])])
    preds = model.generate(emb, max_steps=max_steps, temperature=temperature, top_p=top_p)
    return [{"pred": pred, "refs": dataset.data[i].get("captions", [])}
            for pred, i in zip(preds, idxs)]


def eval_vqa(model, data_dir: str, n_samples: Optional[int] = None, max_steps: int = 8,
             prompt_format: str = "Q: {question} A:", seed: int = 0,
             batch_size: int = 8) -> Dict:
    """Open-ended VQA over a standard-layout dataset directory.  Returns
    {"accuracy", "n", "answers": [{question, pred, answers, acc}]}.  Images
    are decoded lazily, one batch at a time."""
    from PIL import Image

    from magma_tpu_torch.data.dataset import LazyLoader

    data_dir = Path(data_dir)
    loader = LazyLoader(data_dir)
    idxs = list(range(len(loader)))
    if n_samples is not None and n_samples < len(idxs):
        np.random.RandomState(seed).shuffle(idxs)
        idxs = idxs[:n_samples]

    def sample_stream():
        for i in idxs:
            data = loader[i]
            meta = data.get("metadata", {})
            question = meta.get("question")
            if question is None:
                continue
            with Image.open(data_dir / data["image_path"]) as img:
                image = model.transforms(img)
            yield {"question": question, "answers": meta.get("answers", []), "image": image,
                   "tokens": model.tokenizer.encode(prompt_format.format(question=question))[0]}

    def batched(it, n):
        buf = []
        for s in it:
            buf.append(s)
            if len(buf) == n:
                yield buf
                buf = []
        if buf:
            yield buf

    records = []
    eos = model.eos_token
    for chunk in batched(sample_stream(), batch_size):
        text_lens = [len(s["tokens"]) for s in chunk]
        width = max(text_lens)
        tokens = np.full((len(chunk), width), eos, np.int32)  # right-padded with EOS
        for r, s in enumerate(chunk):
            tokens[r, :text_lens[r]] = s["tokens"]
        emb = model.embed([_images_on(model, [s["image"] for s in chunk]), tokens])
        n_img = emb.shape[1] - width
        prompt_len = torch.tensor([n_img + t for t in text_lens], dtype=torch.int32,
                                  device=model.device)
        preds = model.generate(emb, max_steps=max_steps, temperature=0.0, prompt_len=prompt_len)
        for s, pred in zip(chunk, preds):
            pred = re.split(r"[\n.]", pred)[0].strip()  # the first line or sentence
            records.append({"question": s["question"], "pred": pred, "answers": s["answers"],
                            "acc": vqa_accuracy(pred, s["answers"])})

    acc = float(np.mean([r["acc"] for r in records])) if records else 0.0
    return {"accuracy": acc, "n": len(records), "answers": records}

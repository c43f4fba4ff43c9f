"""Training CLI: ``python -m magma_tpu_torch.train --config configs/MAGMA_v1.yml``.

Port of the repository's ``train.py`` (the reference's trainer,
train.py:72-193): the config surface, the dataset concat and held-out
split, the threaded loader, ``Trainer`` steps with the loss read only at
``log_every``, periodic eval (the eval loss, captions of eval images with
their image grid, VQA/GQA accuracy over ``vqa_dir``/``gqa_dir``), periodic
and final checkpoints, and resume from ``load``.  One process on one card
(``--device``, default cuda; the CPU when asked for), or with
``--multihost`` one process per rank under ``torchrun --nproc_per_node N``
(``utils.init_distributed``: NCCL and ``cuda:LOCAL_RANK`` on the card,
gloo with ``--device cpu``): the Trainer's mesh comes from the config's
``mesh_dp``/``mesh_tp``/``mesh_sp``, each rank's loaders take its "dp"
stride of every global batch (``batch_size / dp`` samples), and
checkpoints, metrics and prints come from rank 0 only.

Metrics go to ``metrics.jsonl`` in ``--log-dir`` (default ``config.save``,
else the working directory), with the image grids as PNGs beside it; the
port has no wandb logging.  Each logged train step also records the
time the loop waited on the loader (``train/loader_wait``).  ``--trace``
records the program's spans and counters (``observability.tracing``) and
writes them at exit as a Chrome trace, ``spans_rank{r}.json`` beside the
metrics.  ``main(argv)`` runs in-process and returns the ``Trainer``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time

os.environ.setdefault("TOKENIZERS_PARALLELISM", "false")
os.environ.setdefault("HF_HUB_OFFLINE", "1")
os.environ.setdefault("TRANSFORMERS_OFFLINE", "1")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(prog="python -m magma_tpu_torch.train")
    parser.add_argument("--config", type=str, required=True,
                        help="path to your training config")
    parser.add_argument("--device", type=str, default="cuda",
                        help="the card to train on (default cuda); 'cpu' for the CPU")
    parser.add_argument("--log-dir", type=str, default=None,
                        help="where metrics.jsonl goes (default: config.save, else .)")
    parser.add_argument("--multihost", action="store_true",
                        help="one process per rank, launched by torchrun")
    parser.add_argument("--trace", action="store_true",
                        help="record the program's spans and counters and write them to "
                             "spans_rank{r}.json in the log directory at exit")
    return parser.parse_args(argv)


def _load_img_cpt_datasets(dataset_dir, tokenizer, transforms, seq_len):
    from magma_tpu_torch.data.dataset import ConcatDataset, ImgCptDataset

    if isinstance(dataset_dir, (list, tuple)):
        return ConcatDataset([_load_img_cpt_datasets(d, tokenizer, transforms, seq_len)
                              for d in dataset_dir])
    if isinstance(dataset_dir, str):
        return ImgCptDataset(dataset_dir, tokenizer=tokenizer, transforms=transforms,
                             seq_len=seq_len)
    raise TypeError("dataset dir wrong type")


def get_pretraining_datasets(config, tokenizer, transforms, seq_len):
    """(train, eval) datasets: ``train_dataset_dir`` (a directory or a
    list of them, concatenated); the eval set from ``eval_dataset_dir``,
    or, when that is null, ``eval_dataset_pct`` of the training samples
    held out by a seeded split."""
    from magma_tpu_torch.data.dataset import random_split
    from magma_tpu_torch.utils import print_main

    train_dataset = _load_img_cpt_datasets(config.train_dataset_dir, tokenizer, transforms,
                                           seq_len)
    if config.eval_dataset_dir is None:
        eval_len = int(len(train_dataset) * config.eval_dataset_pct)
        train_len = len(train_dataset) - eval_len
        print_main(f"no eval_dataset_dir: holding out {eval_len} of {len(train_dataset)} "
                   "training samples for eval")
        train_dataset, eval_dataset = random_split(train_dataset, [train_len, eval_len],
                                                   seed=config.seed)
    else:
        eval_dataset = _load_img_cpt_datasets(config.eval_dataset_dir, tokenizer, transforms,
                                              seq_len)
    print_main(f"Loaded train dataset with {len(train_dataset)} samples")
    print_main(f"Loaded eval dataset with {len(eval_dataset)} samples")
    return train_dataset, eval_dataset


class MetricLogger:
    """A JSONL file of metrics, rank-0 gated (the JSONL half of
    train.py:136-180)."""

    def __init__(self, log_dir: str):
        from magma_tpu_torch.utils import is_main

        self._is_main = is_main()
        self._file = None
        if not self._is_main:
            return
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "metrics.jsonl")
        self._file = open(self.path, "a")

    def log(self, metrics: dict, step: int) -> None:
        if not self._is_main:
            return
        self._file.write(json.dumps(dict(metrics, step=step, time=time.time())) + "\n")
        self._file.flush()

    def log_image(self, key: str, image, step: int, caption: str = "") -> None:
        """A (3, H, W) float image in [0, 1]: a PNG beside the JSONL (its path
        logged under ``key``)."""
        if not self._is_main:
            return
        import numpy as np
        from PIL import Image

        arr = np.asarray(image)
        arr = np.clip(arr, 0.0, 1.0) if arr.dtype.kind == "f" else arr
        path = os.path.join(os.path.dirname(self.path),
                            f"{key.replace('/', '_')}_step{step}.png")
        Image.fromarray(np.transpose((arr * 255).astype("uint8"), (1, 2, 0))).save(path)
        self.log({key: path, f"{key}/caption": caption}, step)

    def close(self) -> None:
        if self._file is not None:
            self._file.close()


def main(argv=None):
    args = parse_args(argv)
    from magma_tpu_torch.utils import init_distributed

    device = args.device
    if args.multihost:
        local_rank, _, _ = init_distributed(device)
        if device == "cuda":
            device = f"cuda:{local_rank}"

    from magma_tpu_torch.config import MultimodalConfig
    from magma_tpu_torch.data.loader import BatchLoader
    from magma_tpu_torch.data.transforms import get_transforms
    from magma_tpu_torch.evaluation import eval_vqa
    from magma_tpu_torch.models.magma import Magma
    from magma_tpu_torch import observability
    from magma_tpu_torch.observability import make_grid
    from magma_tpu_torch.training.train_loop import Trainer
    from magma_tpu_torch.utils import count_parameters, get_world_info, print_main

    config = MultimodalConfig.from_yml(args.config)
    config.print()

    model = Magma(config, seed=config.seed, device=device)
    print_main(f"params: {count_parameters(model.params):,} "
               f"(trainable: {count_parameters(model.params, model.trainable_mask()):,})")
    trainer = Trainer(model, config)
    # each rank loads its "dp" stride of every global batch
    dp, dp_index = trainer.mesh.size("dp"), trainer.mesh.axis_index("dp")

    # the loader's workers take the host path: the native decoder when it
    # builds, else PIL and the CPU preprocess
    transforms = get_transforms(config.image_size, config.encoder_name,
                                input_resolution=model.prefix_config.input_resolution)
    print_main(f"data transforms: {type(transforms).__name__}")
    train_dataset, eval_dataset = get_pretraining_datasets(config, model.tokenizer, transforms,
                                                           model.seq_len)
    train_loader = BatchLoader(train_dataset, config.batch_size // dp,
                               config.gradient_accumulation_steps, seq_len=model.seq_len,
                               num_workers=config.num_workers, seed=config.seed,
                               device=model.device, shard=(dp_index, dp))
    eval_loader = BatchLoader(eval_dataset,
                              max(config.batch_size // config.gradient_accumulation_steps // dp,
                                  1), 1,
                              seq_len=model.seq_len, num_workers=config.num_workers,
                              seed=config.seed + 1, flat=True, device=model.device,
                              shard=(dp_index, dp))

    global_step = 0
    if config.load:
        global_step = trainer.load(config.load, load_optimizer=config.load_optimizer)
        if not config.load_optimizer:
            trainer.global_step = global_step = 0

    log_dir = args.log_dir or config.save or "."
    logger = MetricLogger(log_dir)
    print_main(f"training from step {global_step} to {config.train_steps}")

    t_interval = time.perf_counter()
    steps_in_interval, waited = 0, 0.0
    traced = observability.tracing() if args.trace else contextlib.nullcontext()
    traced.__enter__()
    try:
        while global_step < config.train_steps:
            t_wait = time.perf_counter()
            images, captions = next(train_loader)
            waited += time.perf_counter() - t_wait
            # sync=False: the card runs this step while the host fetches the
            # next batch; the loss is read only at logging boundaries
            loss = trainer.train_step(images, captions, sync=False)
            global_step = trainer.global_step
            steps_in_interval += 1

            if global_step % config.log_every == 0:
                loss = float(loss)  # waits for the queued steps
                step_time = (time.perf_counter() - t_interval) / steps_in_interval
                loader_wait = waited / steps_in_interval
                t_interval, steps_in_interval, waited = time.perf_counter(), 0, 0.0
                print_main(f"step {global_step} loss {loss:.4f} ({step_time:.2f}s/step, "
                           f"{loader_wait:.3f}s waiting on the loader)")
                logger.log({"train/loss": loss, "train/step_time": step_time,
                            "train/loader_wait": loader_wait}, global_step)

            if global_step % config.eval_every == 0:
                eval_loss = trainer.eval_step(eval_loader)
                logger.log({"eval/loss": eval_loss}, global_step)
                print_main(f"step {global_step} eval loss {eval_loss:.4f}")
                eval_images, caption_text = trainer.inference_step(
                    eval_loader, max_steps=30, temperature=0.7, top_p=0.9)
                logger.log({"inference/captions": caption_text}, global_step)
                logger.log_image("inference/images", make_grid(eval_images), global_step,
                                 caption=caption_text)
                print_main(caption_text)
                for tag, qa_dir in (("vqa", config.vqa_dir), ("gqa", config.gqa_dir)):
                    if not qa_dir:
                        continue
                    trainer.sync_model()
                    res = eval_vqa(model, qa_dir, n_samples=64)
                    logger.log({f"eval/{tag}_accuracy": res["accuracy"]}, global_step)
                    print_main(f"step {global_step} {tag} accuracy {res['accuracy']:.3f} over "
                               f"{res['n']} questions")
                # the interval's step time counts training steps only
                t_interval, steps_in_interval, waited = time.perf_counter(), 0, 0.0

            if config.save is not None and global_step % config.save_every == 0:
                trainer.save(config.save)
                print_main(f"saving model at step {global_step}")

        if config.save is not None:
            trainer.save(config.save)
            print_main(f"saving model at end of training (step {global_step})")
    finally:
        traced.__exit__(None, None, None)
        if args.trace:
            os.makedirs(log_dir, exist_ok=True)
            path = os.path.join(log_dir, f"spans_rank{get_world_info()[1]}.json")
            observability.export_chrome_trace(path, *observability.take())
            print_main(f"spans written to {path}")
        train_loader.close()
        eval_loader.close()
        logger.close()
    return trainer


if __name__ == "__main__":
    args = parse_args()
    main()
    if args.multihost:
        import torch.distributed as dist

        # every rank past its last collective and write before any tears
        # down: a gloo peer that closes first can abort the others' exit
        dist.barrier()
        dist.destroy_process_group()

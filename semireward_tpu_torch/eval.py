"""Offline evaluation CLI of the port (the JAX package's ``eval.py``).

    python -m semireward_tpu_torch.eval --load_path <ckpt> [--dataset ...]
        [--net ...] [--num_classes ...] [--use_train_model] [--device cpu]

Loads a checkpoint's EMA weights (``--use_train_model``: the trained ones)
and BatchNorm buffers, whichever algorithm wrote it, scores the eval split
and prints each metric and, last, ``Test Accuracy: ...``. Runs on the first
CUDA card unless ``--device`` says otherwise.
"""
from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--load_path", type=str, required=True)
    p.add_argument("--dataset", type=str, default="cifar10")
    p.add_argument("--data_dir", type=str, default="./data")
    p.add_argument("--net", type=str, default="wrn_28_2")
    p.add_argument("--num_classes", type=int, default=10)
    p.add_argument("--img_size", type=int, default=32)
    p.add_argument("--crop_ratio", type=float, default=0.875)
    # NLP / audio geometry (reference eval.py:33-35)
    p.add_argument("--max_length", type=int, default=512)
    p.add_argument("--max_length_seconds", type=float, default=4.0)
    p.add_argument("--sample_rate", type=int, default=16000)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--use_train_model", action="store_true",
                   help="evaluate the trained weights, not the EMA shadow")
    p.add_argument("--device", default=None,
                   help="torch device; default: the first CUDA card")
    args = p.parse_args(argv)

    from semireward_tpu_torch.config import get_config
    from semireward_tpu_torch.core.trainer import Trainer

    cfg = get_config(dict(
        algorithm="fixmatch", net=args.net, dataset=args.dataset,
        data_dir=args.data_dir, num_classes=args.num_classes,
        num_labels=args.num_classes, img_size=args.img_size,
        crop_ratio=args.crop_ratio, max_length=args.max_length,
        max_length_seconds=args.max_length_seconds,
        sample_rate=args.sample_rate,
        eval_batch_size=args.batch_size, num_train_iter=1, num_eval_iter=1,
        save_name="eval"))
    tr = Trainer(cfg, device=args.device)
    tr.load_weights(args.load_path)
    tr.eval_use_ema = not args.use_train_model
    metrics = tr.evaluate()
    for k, v in sorted(metrics.items()):
        print(f"{k}: {v:.4f}")
    print(f"Test Accuracy: {metrics['top-1-acc']:.4f}")
    return metrics


if __name__ == "__main__":
    main()

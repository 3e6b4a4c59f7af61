"""Training CLI on PyTorch (mccnn_tpu/cli/train.py).

Flag-compatible with the JAX package's trainer (and through it with the
reference's train.py): ``--list_dir`` holding train.txt / val.txt, the
checkpoint and metrics directories, resume path, epoch range, print /
save / val frequencies and the paper's hyperparameters, plus ``--device``
(default ``cuda``; a CUDA request with no card fails). Metrics go to
``metrics.jsonl`` (events ``start``, ``train``, ``checkpoint``, ``val``)
and checkpoints are ``model_epoch{N}.npz`` in the JAX package's format, so
either package resumes from the other's.

``--data_parallel`` keeps the JAX trainer's meaning, the batch sharded over
all local devices (``parallel/train.py``): run plainly on ``cuda`` it
spawns one rank per visible card over NCCL (one card: one rank in this
process), on ``--device cpu`` it runs one gloo rank; under torchrun
(``RANK`` and ``WORLD_SIZE`` set) each process joins the given group. Every
rank draws the same global batch from the same seeded sampler and keeps its
slice, so the sample stream is the single-process one; only rank 0 writes
checkpoints and ``metrics.jsonl`` and runs the validation.

Usage:

    python -m mccnn_tpu_torch.cli.train --list_dir lists \\
        --tensorboard_dir logs --checkpoint_dir ckpt [--device cpu] \\
        [--resume ckpt/model_epoch3.npz] [--sampler_backend native]
    torchrun --nproc_per_node 2 -m mccnn_tpu_torch.cli.train \\
        --data_parallel --device cpu --list_dir lists ...
"""

from __future__ import annotations

import argparse
import os
import sys


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
        description="training of MC-CNN (PyTorch / CUDA)",
    )
    parser.add_argument("-g", "--gpu", type=str, default="0",
                        help="accepted for reference compatibility; see "
                             "--device")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device; a CUDA request with no card fails")
    parser.add_argument("-ps", "--patch_size", type=int, default=11)
    parser.add_argument("-bs", "--batch_size", type=int, default=128)
    parser.add_argument("-mr", "--margin", type=float, default=0.2)
    parser.add_argument("-lr", "--learning_rate", type=float, default=0.002)
    parser.add_argument("-bt", "--beta", type=float, default=0.9)
    parser.add_argument("--list_dir", type=str, required=True)
    parser.add_argument("--tensorboard_dir", type=str, required=True,
                        help="metrics dir (JSONL instead of TF summaries)")
    parser.add_argument("--checkpoint_dir", type=str, required=True)
    parser.add_argument("--resume", type=str, default=None,
                        help="model_epochN.npz of either package (params "
                             "and momentum), or weights only (any file "
                             "models.params.load_any reads)")
    parser.add_argument("--start_epoch", type=int, default=0)
    parser.add_argument("--end_epoch", type=int, default=14)
    parser.add_argument("--print_freq", type=int, default=10)
    parser.add_argument("--save_freq", type=int, default=1)
    parser.add_argument("--val_freq", type=int, default=1)
    parser.add_argument("--seed", type=int, default=0,
                        help="sampler and shuffle seed, and the seed of the "
                             "initial weights; those come from numpy's "
                             "generator, not JAX's PRNG, so they differ from "
                             "the JAX trainer's for the same seed (pass its "
                             "weights with --resume to start from them)")
    parser.add_argument("--data_parallel", action="store_true",
                        help="shard the batch over all local devices (one "
                             "rank per card; one gloo rank on the CPU; the "
                             "given group under torchrun)")
    parser.add_argument("--sampler_backend", type=str, default="numpy",
                        choices=["numpy", "native", "auto"],
                        help="host patch-sampler implementation (native = "
                             "the C++ sampler in native/)")
    parser.add_argument("--prefetch_batches", type=int, default=2,
                        help="overlap host sampling with device steps via a "
                             "background thread holding up to N batches "
                             "(bit-identical sample stream; 0 = synchronous)")
    return parser


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    if not args.data_parallel:
        return _train(args)

    import torch
    import torch.distributed as dist

    from mccnn_tpu_torch.parallel.launch import free_port, run_ranks
    from mccnn_tpu_torch.parallel.mesh import make_mesh
    from mccnn_tpu_torch.parallel.multihost import initialize_distributed

    cuda = torch.device(args.device).type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError(f"device {args.device!r} requested but CUDA is "
                           "not available")
    torchrun = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    if cuda and not torchrun and torch.cuda.device_count() > 1:
        run_ranks(_train_rank, torch.cuda.device_count(),
                  sys.argv[1:] if argv is None else argv, device="cuda",
                  timeout_s=None)
        return None
    if torchrun:
        initialize_distributed(device=args.device)
    else:  # one rank: this process
        initialize_distributed(f"127.0.0.1:{free_port()}", 1, 0,
                               device=args.device)
    try:
        _train(args, make_mesh(device=args.device))
    finally:
        dist.destroy_process_group()
    return None


def _train_rank(mesh, argv) -> None:
    """One rank of a spawned ``--data_parallel`` run."""
    _train(build_parser().parse_args(argv), mesh)


def _train(args, mesh=None) -> None:
    """The training loop; with a ``mesh`` one data-parallel rank of it."""
    import torch

    from mccnn_tpu_torch.data.dataset import StereoDataset
    from mccnn_tpu_torch.data.sampler import TripletSampler
    from mccnn_tpu_torch.models.net import (
        init_params,
        params_from_numpy,
        params_to_numpy,
    )
    from mccnn_tpu_torch.models.params import load_any
    from mccnn_tpu_torch.pipeline.train import (
        batch_to_device,
        load_momentum,
        make_eval_step,
        make_optimizer,
        make_train_step,
        momentum_to_numpy,
    )
    from mccnn_tpu_torch.utils.checkpoint import (
        epoch_of,
        load_checkpoint,
        save_checkpoint,
    )
    from mccnn_tpu_torch.utils.config import TrainConfig
    from mccnn_tpu_torch.utils.metrics import MetricsLogger

    device = torch.device(args.device) if mesh is None else mesh.device
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {args.device!r} requested but CUDA is "
                           "not available")
    lead = mesh is None or mesh.rank == 0  # writes files, validates
    config = TrainConfig(
        batch_size=args.batch_size,
        margin=args.margin,
        learning_rate=args.learning_rate,
        beta=args.beta,
        start_epoch=args.start_epoch,
        end_epoch=args.end_epoch,
        print_freq=args.print_freq,
        save_freq=args.save_freq,
        val_freq=args.val_freq,
    )

    train_set = StereoDataset(
        os.path.join(args.list_dir, "train.txt"), shuffle=True, seed=args.seed
    )
    val_set = StereoDataset(os.path.join(args.list_dir, "val.txt"))
    train_sampler, val_sampler = (
        TripletSampler(
            dataset, patch_size=args.patch_size, seed=seed,
            dataset_pos=config.dataset_pos,
            dataset_neg_low=config.dataset_neg_low,
            dataset_neg_high=config.dataset_neg_high,
            backend=args.sampler_backend,
        )
        for dataset, seed in ((train_set, args.seed),
                              (val_set, args.seed + 1)))

    params = init_params(args.seed)
    momentum = None
    start_epoch = config.start_epoch
    if args.resume:
        if args.resume.endswith(".npz") and "model_epoch" in args.resume:
            restored = load_checkpoint(
                args.resume, {"params": params, "momentum": params})
            params, momentum = restored["params"], restored["momentum"]
            start_epoch = max(start_epoch, epoch_of(args.resume))
        else:  # weights only: a fresh optimizer
            params = load_any(args.resume)
    net = params_from_numpy(params).to(device)
    optimizer = make_optimizer(config, net)
    if momentum is not None:
        load_momentum(net, optimizer, momentum)
    if mesh is None:
        train_step = make_train_step(config, net, optimizer)

        def to_device(batch):
            return batch_to_device(batch, device)
    else:
        from mccnn_tpu_torch.parallel.train import (
            make_dp_train_step,
            shard_batch,
        )

        train_step = make_dp_train_step(config, net, mesh, optimizer)

        def to_device(batch):
            return shard_batch(batch, mesh)
    eval_step = make_eval_step(config, net)

    logger = MetricsLogger(
        os.path.join(args.tensorboard_dir, "metrics.jsonl") if lead else None,
        echo=lead, tensorboard_dir=args.tensorboard_dir if lead else None,
    )
    logger.log(event="start", train_pairs=len(train_set),
               val_pairs=len(val_set), devices=1 if mesh is None else
               mesh.size, device=str(device),
               **({} if mesh is None else {"backend": mesh.backend}))

    try:
        from tqdm import tqdm
    except ImportError:  # pragma: no cover
        tqdm = lambda x, **kw: x  # noqa: E731

    train_feed = train_sampler
    if args.prefetch_batches > 0 and config.end_epoch > start_epoch:
        from mccnn_tpu_torch.data.prefetch import BatchPrefetcher

        train_feed = BatchPrefetcher(
            train_sampler, config.batch_size, epoch_len=len(train_set),
            depth=args.prefetch_batches,
        )

    try:
        for epoch in range(start_epoch, config.end_epoch):
            for batch_idx in tqdm(range(len(train_set)),
                                  desc=f"epoch {epoch + 1}", leave=False):
                batch = to_device(train_feed.next_batch(config.batch_size))
                loss = train_step(batch)
                if lead and (batch_idx + 1) % config.print_freq == 0:
                    logger.log(step=epoch * len(train_set) + batch_idx,
                               event="train", epoch=epoch + 1,
                               batch=batch_idx + 1, hinge_loss=float(loss))

            if lead and (epoch + 1) % config.save_freq == 0:
                path = save_checkpoint(args.checkpoint_dir, epoch + 1,
                                       params_to_numpy(net),
                                       momentum_to_numpy(net, optimizer))
                logger.log(event="checkpoint", epoch=epoch + 1, path=path)

            if lead and (epoch + 1) % config.val_freq == 0:
                val_loss = 0.0
                for _ in tqdm(range(len(val_set)), desc="val", leave=False):
                    batch = batch_to_device(
                        val_sampler.next_batch(config.batch_size), device)
                    val_loss += float(eval_step(batch))
                val_loss /= max(1, len(val_set))
                logger.log(step=len(train_set) * (epoch + 1), event="val",
                           epoch=epoch + 1, val_hinge_loss=val_loss)

            train_feed.reset()  # the prefetcher forwards to the sampler
            val_sampler.reset()
    finally:
        if train_feed is not train_sampler:
            train_feed.close()
        logger.close()


if __name__ == "__main__":
    main()

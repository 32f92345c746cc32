"""Command-line entry point of the port: the JAX package's flags
(rainbow_tpu/cli.py:17-134, itself the reference's main.py:21-61 plus the
batched-engine knobs) on top of the typed config presets.

Run:  python -m rainbow_tpu_torch.cli --game pong --num-envs 1024
Eval: python -m rainbow_tpu_torch.cli --evaluate --model results/default/model.npz
Two processes, one GPU each (NCCL), the same flags but --process-id:
      python -m rainbow_tpu_torch.cli --num-envs 1024 --process-count 2 \
          --process-id 0 --coordinator 127.0.0.1:29500   (and --process-id 1)

Training runs on the card; ``main(device="cpu")`` is for tests.
"""
from __future__ import annotations

import argparse

import torch
import torch.distributed as dist

from rainbow_tpu_torch import config as cfg_mod
from rainbow_tpu_torch.utils.logging import log


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="rainbow-tpu on PyTorch and CUDA")
    p.add_argument("--preset", default="canonical",
                   choices=sorted(cfg_mod.PRESETS),
                   help="hyperparameter preset (reference defaults vs "
                        "Atari-100k data-efficient, README.md:25-36)")
    p.add_argument("--id", dest="run_id", default="default")
    p.add_argument("--seed", type=int, default=123)
    # Constrained to the engine catalogue, like the reference's
    # choices=atari_py.list_games() (main.py:25) — errors at parse time
    # instead of later from BatchedEnv.
    from rainbow_tpu_torch.envs.engine import GAMES
    p.add_argument("--game", default="pong", choices=sorted(GAMES))
    p.add_argument("--T-max", dest="total_steps", type=int, default=None,
                   metavar="STEPS")
    p.add_argument("--max-episode-length", type=int, default=None)
    p.add_argument("--history-length", type=int, default=None)
    from rainbow_tpu_torch.models.dqn import TORSOS
    p.add_argument("--architecture", default=None, choices=sorted(TORSOS))
    p.add_argument("--hidden-size", type=int, default=None)
    p.add_argument("--noisy-std", type=float, default=None)
    p.add_argument("--atoms", type=int, default=None)
    p.add_argument("--V-min", dest="v_min", type=float, default=None)
    p.add_argument("--V-max", dest="v_max", type=float, default=None)
    p.add_argument("--model", dest="model_path", default=None)
    p.add_argument("--memory-capacity", type=int, default=None)
    p.add_argument("--replay-frequency", type=int, default=None)
    p.add_argument("--priority-exponent", type=float, default=None)
    p.add_argument("--priority-weight", type=float, default=None)
    p.add_argument("--multi-step", type=int, default=None)
    p.add_argument("--discount", type=float, default=None)
    p.add_argument("--target-update", type=int, default=None)
    p.add_argument("--reward-clip", type=float, default=None)
    p.add_argument("--learning-rate", type=float, default=None)
    p.add_argument("--adam-eps", type=float, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--norm-clip", type=float, default=None)
    p.add_argument("--learn-start", type=int, default=None)
    p.add_argument("--evaluate", action="store_true")
    p.add_argument("--evaluation-interval", type=int, default=None)
    p.add_argument("--evaluation-episodes", type=int, default=None)
    p.add_argument("--evaluation-size", type=int, default=None)
    p.add_argument("--checkpoint-interval", type=int, default=None)
    p.add_argument("--memory", dest="memory_path", default=None)
    p.add_argument("--memory-save-interval", type=int, default=None,
                   help="env-steps between replay-bearing saves "
                        "(0 = at every evaluation, reference parity)")
    p.add_argument("--no-compress-memory", dest="compress_memory",
                   action="store_false", default=None,
                   help="disable deflate on replay-bearing saves "
                        "(the reference's --disable-bzip-memory)")
    p.add_argument("--resume", default=None, metavar="CKPT",
                   help="restore a full atomic checkpoint (exact resume — "
                        "unlike the reference's partial weights+memory resume)")
    p.add_argument("--render", action="store_true", default=None,
                   help="save eval-episode frames (reference --render)")
    # Batched-engine and device knobs (the JAX package's "TPU-native" flags)
    p.add_argument("--num-envs", type=int, default=None)
    p.add_argument("--compute-dtype", default=None,
                   choices=["float32", "bfloat16"])
    p.add_argument("--adam-mu-dtype", default=None,
                   choices=["float32", "bfloat16"],
                   help="Adam first-moment storage dtype (bf16 halves the "
                        "m-term of the learner's HBM-floor traffic)")
    p.add_argument("--env-backend", default=None, choices=["native", "fake"])
    p.add_argument("--pipeline-actor", action="store_true", default=None)
    p.add_argument("--delta-uploads", action="store_true", default=None,
                   help="send observations as sparse pixel deltas "
                        "(lossless; cuts host->device payload)")
    p.add_argument("--pipeline-depth", type=int, default=None)
    p.add_argument("--settle-window", type=int, default=None,
                   help="max in-flight fused iterations before the loop "
                        "settles the oldest (see config.settle_window)")
    p.add_argument("--data-parallel", action="store_true", default=None)
    p.add_argument("--per-env-noise", action="store_true", default=None,
                   help="independent NoisyNet draw per env at act time "
                        "(decorrelated batched exploration)")
    p.add_argument("--sequential-per", action="store_true", default=None,
                   help="exact reference PER sequencing (re-sample against "
                        "latest priorities every update) instead of the "
                        "batched-PER round (one sample+gather per round)")
    p.add_argument("--eval-workers", type=int, default=None,
                   help="concurrent async evaluations (overlap dispatch "
                        "round trips on high-latency links)")
    p.add_argument("--max-pending-evals", type=int, default=None,
                   help="async-eval snapshot-queue depth before scheduled "
                        "evals are skipped (skips recorded in metrics)")
    p.add_argument("--async-eval", action="store_true", default=None,
                   help="run evaluations on a background thread against a "
                        "params snapshot (keeps eval off the training loop's "
                        "critical path)")
    p.add_argument("--profile", action="store_true", default=None,
                   help="capture a torch.profiler trace of the training loop")
    # Multi-process training (torch.distributed): one process per GPU with
    # the same flags except --process-id. Each runs num_envs/P envs and its
    # own replay shard; the learner averages gradients over all of them
    # (parallel/learner.py).
    p.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                   help="rank 0's address for torch.distributed "
                        "(multi-process)")
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--process-count", type=int, default=None)
    return p


def parse_config(argv=None):
    args = build_parser().parse_args(argv)
    probe = cfg_mod.PRESETS[args.preset]()
    overrides = {k: v for k, v in vars(args).items()
                 if v is not None and k not in ("preset", "evaluate", "resume")
                 and hasattr(probe, k)}
    # Build the preset WITH the CLI overrides as its kwargs, not on top of
    # the finished preset: preset functions derive dependent fields from
    # their inputs (the throughput preset sqrt-scales lr from batch_size),
    # so `--preset throughput --batch-size 512` must reach the derivation,
    # not silently keep the lr tuned for the preset's default batch
    # (ADVICE r4).
    cfg = cfg_mod.PRESETS[args.preset](**overrides)
    return cfg, args


def main(argv=None, device="cuda"):
    """Train, or with --evaluate evaluate, as the flags say; returns the
    Trainer. With --process-count > 1 this process joins the process group
    first (NCCL on CUDA, gloo on the CPU), unless one exists already, and
    runs on ``cuda:{local rank}`` (the process id modulo the local GPUs)
    unless ``device`` names the CPU or a card."""
    cfg, args = parse_config(argv)
    if args.process_count and args.process_count > 1:
        if not args.coordinator or args.process_id is None:
            raise ValueError("--process-count > 1 needs --coordinator "
                             "HOST:PORT (rank 0's address) and --process-id")
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", args.process_id
                               % max(torch.cuda.device_count(), 1))
            device = dev
        if not (dist.is_available() and dist.is_initialized()):
            from rainbow_tpu_torch.parallel.mesh import init_distributed
            init_distributed(args.coordinator, args.process_count,
                             args.process_id, device)
    # Echo options (reference main.py:63-65).
    print(" " * 26 + "Options")
    for k, v in sorted(vars(cfg).items()):
        print(" " * 26 + f"{k}: {v}")

    from rainbow_tpu_torch.train import Trainer

    trainer = Trainer(cfg, device=device)
    if args.resume:
        trainer.restore_checkpoint(args.resume)
    if args.evaluate:  # reference main.py:138-141
        avg_r, avg_q = trainer.evaluate_now(trainer.build_validation_states(),
                                            evaluate_only=True)
        print(f"Avg. reward: {avg_r} | Avg. Q: {avg_q}")
    else:
        trainer.run()
        log("Training complete")
    return trainer


if __name__ == "__main__":
    main()

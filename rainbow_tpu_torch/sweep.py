"""Multi-game sweeps (rainbow_tpu/sweep.py:29-112): trains every
requested game with a shared preset and writes a summary table (JSON +
markdown) of final and best evaluation rewards beside a random-policy
baseline.

Run:  python -m rainbow_tpu_torch.sweep --preset data-efficient --T-max 100000
      [--games pong breakout ...]

--shard-index/--shard-count: each launched process trains its round-robin
slice of the game list on its own card, with a shared results dir.
"""
from __future__ import annotations

import json
import os
from typing import List

from rainbow_tpu_torch import config as cfg_mod
from rainbow_tpu_torch.cli import build_parser
from rainbow_tpu_torch.envs.engine import GAMES
from rainbow_tpu_torch.utils.logging import log


def random_policy_baseline(cfg) -> float:
    """Mean episode reward of a uniform-random policy under the eval
    protocol (true game-over terminals) — the floor every learning result
    is reported against (reference test.py's protocol has no baseline; the
    published curves imply one)."""
    import numpy as np

    from rainbow_tpu_torch.train import make_env_factory

    env = make_env_factory(cfg)(num_envs=cfg.evaluation_episodes,
                                training=False, seed_offset=5555)
    env.reset_all()
    rng = np.random.default_rng(cfg.seed + 99)
    totals = np.zeros(cfg.evaluation_episodes)
    finished = np.zeros(cfg.evaluation_episodes, bool)
    max_iters = (cfg.max_episode_length or 10 ** 9) // 4 + 100
    it = 0
    while not finished.all() and it < max_iters:
        _, _, r, d, _ = env.step(
            rng.integers(0, env.action_space, cfg.evaluation_episodes))
        totals += np.where(finished, 0.0, r)
        finished |= d.astype(bool)
        it += 1
    env.close()
    return float(totals.mean())


def run_sweep(argv=None, device="cuda") -> dict:
    """Train each game of --games in turn (on ``device``; the CPU is for
    tests) and write sweep.json and sweep.md into results/<id>/."""
    parser = build_parser()
    parser.add_argument("--games", nargs="*", default=list(GAMES),
                        help="game list; the single token 'atari100k' "
                             "expands to the 26-game Atari-100k suite")
    parser.add_argument("--shard-index", type=int,
                        default=int(os.environ.get("RAINBOW_PROC_INDEX", 0)))
    parser.add_argument("--shard-count", type=int,
                        default=int(os.environ.get("RAINBOW_PROC_COUNT", 1)))
    args = parser.parse_args(argv)
    if args.games == ["atari100k"]:
        from rainbow_tpu_torch.envs.engine import ATARI_100K_GAMES
        args.games = list(ATARI_100K_GAMES)
    probe = cfg_mod.PRESETS[args.preset]()
    overrides = {k: v for k, v in vars(args).items()
                 if v is not None and hasattr(probe, k)
                 and k not in ("games", "shard_index", "shard_count")}
    # Overrides go through the preset function's kwargs so derived fields
    # (e.g. the throughput preset's batch-dependent lr) see them (ADVICE r4).
    cfg = cfg_mod.PRESETS[args.preset](**overrides)

    my_games: List[str] = [g for i, g in enumerate(args.games)
                           if i % args.shard_count == args.shard_index]
    results = {}
    from rainbow_tpu_torch.train import Trainer
    for game in my_games:
        run_cfg = cfg.replace(game=game, run_id=f"{cfg.run_id}-{game}")
        log(f"=== sweep: {game} ===")
        baseline = random_policy_baseline(run_cfg)
        log(f"=== {game}: random-policy baseline {baseline:.1f} ===")
        tr = Trainer(run_cfg, device=device)
        metrics = tr.run()
        rewards = metrics["rewards"][-1] if metrics["rewards"] else []
        results[game] = {
            "best_avg_reward": metrics["best_avg_reward"],
            "final_avg_reward": (sum(rewards) / len(rewards)
                                 if rewards else None),
            "random_baseline": baseline,
            "evals": len(metrics["steps"]),
        }
        log(f"=== {game}: best={results[game]['best_avg_reward']} "
            f"(random {baseline:.1f}) ===")

    out_dir = os.path.join(cfg.results_dir, cfg.run_id)
    os.makedirs(out_dir, exist_ok=True)
    suffix = (f".p{args.shard_index}" if args.shard_count > 1 else "")
    with open(os.path.join(out_dir, f"sweep{suffix}.json"), "w") as f:
        json.dump(results, f, indent=2)
    lines = ["| game | random baseline | best avg reward | "
             "final avg reward | evals |", "|---|---|---|---|---|"]
    for g, r in results.items():
        lines.append(f"| {g} | {r['random_baseline']:.1f} | "
                     f"{r['best_avg_reward']} | "
                     f"{r['final_avg_reward']} | {r['evals']} |")
    with open(os.path.join(out_dir, f"sweep{suffix}.md"), "w") as f:
        f.write("\n".join(lines) + "\n")
    return results


if __name__ == "__main__":
    run_sweep()

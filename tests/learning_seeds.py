"""The JAX package's learning smoke (tests/test_train_smoke.py:200-224) on
the CPU, seed by seed, through the JAX package's Trainer and the port's.

    JAX_PLATFORMS=cpu python tests/learning_seeds.py jax 7 3 42
    JAX_PLATFORMS=cpu python tests/learning_seeds.py port 7 3 42

Prints one line per seed: the greedy probe's reward per episode (the bar
is more than 18.75) and the last round's loss. The port's Trainer starts
from the JAX package's initial params for the seed (init_agent). One
torch and one XLA thread; about a minute a seed.
"""
import dataclasses
import os
import sys

os.environ.setdefault("XLA_FLAGS", "--xla_cpu_multi_thread_eigen=false "
                      "intra_op_parallelism_threads=1")
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402
import torch  # noqa: E402

from test_train_smoke import tiny_cfg  # noqa: E402


def smoke_cfg(seed):
    """The JAX test's configuration (tiny_cfg with its overrides)."""
    return tiny_cfg("results/learning_seeds", total_steps=6000,
                    learn_start=200, evaluation_interval=10 ** 9, num_envs=8,
                    memory_capacity=8 * 512, learning_rate=1e-3,
                    multi_step=3, batch_size=32, seed=seed,
                    run_id=f"seed{seed}")


def run(which, seed):
    """(greedy probe score, last loss) of one Trainer run."""
    cfg = smoke_cfg(seed)
    if which == "jax":
        from rainbow_tpu.train import Trainer
        from test_train_smoke import _greedy_probe_score
        tr = Trainer(cfg)
    else:
        from rainbow_tpu_torch.config import RainbowConfig
        from rainbow_tpu_torch.train import Trainer
        from test_torch_port_learning import _greedy_probe_score
        cfg = RainbowConfig(**dataclasses.asdict(cfg))
        tr = Trainer(cfg, device="cpu")
    tr.run()
    return _greedy_probe_score(tr, cfg), float(tr._last_loss)


def main():
    jax.config.update("jax_platforms", "cpu")
    torch.set_num_threads(1)
    which, seeds = sys.argv[1], [int(s) for s in sys.argv[2:]]
    if which not in ("jax", "port"):
        raise SystemExit(__doc__)
    for seed in seeds:
        score, loss = run(which, seed)
        print(f"{which} seed {seed}: greedy probe {score} per episode "
              f"(bar > 18.75), last loss {loss:.4f}", flush=True)


if __name__ == "__main__":
    main()

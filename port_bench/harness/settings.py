"""A cell's configuration and traffic as the program's command line, and as
the plain reference's hyperparameters. Both come from the same files."""
from __future__ import annotations

import math

from port_bench.reference.rainbow import Hyper


def merged(config: dict, traffic: dict) -> dict:
    """The settings of a run: the configuration's, then the traffic's."""
    return {**config["settings"], **traffic["settings"]}


def cli_args(config: dict, traffic: dict, seed: int, run_id: str) -> list:
    """``rainbow_tpu_torch.cli`` arguments: the preset, then every setting
    as ``--key-with-dashes value`` (a true flag alone, a false one left
    out), the seed and the run's id."""
    args = ["--preset", config["preset"]]
    for key, value in merged(config, traffic).items():
        flag = "--" + key.replace("_", "-")
        if value is True:
            args.append(flag)
        elif value is not False and value is not None:
            args += [flag, str(value)]
    return args + ["--seed", str(seed), "--id", run_id]


def learning_rate(config: dict, traffic: dict) -> float:
    """The published rate, scaled as the configuration's preset scales it."""
    lr = config["learning_rate"]
    s = merged(config, traffic)
    if lr["scaling"] == "sqrt(batch_size/32)":
        return lr["published"] * math.sqrt(s["batch_size"] / 32)
    raise ValueError(f"unknown learning-rate scaling {lr['scaling']!r}")


def hyper(config: dict, traffic: dict) -> Hyper:
    s = merged(config, traffic)
    if s["num_envs"] < s["replay_frequency"]:
        raise ValueError("the reference follows one learner round an "
                         "iteration: num_envs must be >= replay_frequency")
    return Hyper(
        architecture=s["architecture"], hidden=s["hidden_size"],
        atoms=s["atoms"], v_min=float(s["V_min"]), v_max=float(s["V_max"]),
        noisy_std=s["noisy_std"], history=s["history_length"],
        frame=config["frame_size"], multi_step=s["multi_step"],
        discount=s["discount"], priority_exponent=s["priority_exponent"],
        priority_weight=s["priority_weight"],
        learning_rate=learning_rate(config, traffic),
        adam_eps=s["adam_eps"], norm_clip=float(s["norm_clip"]),
        reward_clip=float(s["reward_clip"]), batch_size=s["batch_size"],
        learns_per_iter=s["num_envs"] // s["replay_frequency"],
        num_envs=s["num_envs"],
        capacity_per_env=max(s["memory_capacity"] // s["num_envs"], 1),
        learn_start=s["learn_start"], target_update=s["target_update"],
        total_steps=s["T_max"], compute_dtype=s["compute_dtype"],
        adam_mu_dtype=s["adam_mu_dtype"],
        per_env_noise=bool(s.get("per_env_noise", False)))

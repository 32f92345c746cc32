"""Rainbow agent (rainbow_tpu/agent.py): greedy batched act, ε-greedy eval
act, the validation-Q probe, and the learner's update: the double-Q C51
target, the IS-weighted cross-entropy and its gradient, global-norm clip +
Adam, the sequential learn step and the hard target sync.

Noise is explicit: ``noise`` (a models.noisy.NoiseStream) draws fresh
noise, ``noise_eps`` (models.dqn.draw_noise) supplies it pre-drawn, and
with neither the net runs μ only (eval mode). The agent's noise stream,
``AgentState.noise``, takes the place of the JAX package's ``noise_key``;
its ``generator`` (a torch.Generator) that of ``rng``: the replay's
stratified uniforms.

Unlike the JAX package, updates are in place: ``apply_grads`` writes the
params and the Adam moments (JAX returns new arrays instead).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from rainbow_tpu_torch.config import RainbowConfig
from rainbow_tpu_torch.device import resolve_device
from rainbow_tpu_torch.kernels import adam as k9
from rainbow_tpu_torch.models.dqn import (draw_noise, draw_noise_sets,
                                          forward_head, init_dqn_params,
                                          loss_streams)
from rainbow_tpu_torch.models.noisy import NoiseStream
from rainbow_tpu_torch.ops.c51 import c51_target, head_loss, support_vector
from rainbow_tpu_torch.replay import prioritized as rp

ADAM_B1, ADAM_B2 = 0.9, 0.999  # optax.adam's defaults (agent.py:57)


@dataclasses.dataclass
class AdamState:
    """optax ScaleByAdamState: the moments per param name and the count."""
    mu: dict              # float32, or bfloat16 with adam_mu_dtype bfloat16
    nu: dict              # float32
    count: torch.Tensor   # int32 0-d, on the params' device


@dataclasses.dataclass
class AgentState:
    params: dict
    target_params: dict
    opt_state: AdamState
    generator: torch.Generator  # the replay's stratified uniforms
    step: int = 0               # learner updates applied
    noise: NoiseStream = dataclasses.field(  # every noisy-layer draw
        default_factory=lambda: NoiseStream(0))


def _mu_dtype(cfg: RainbowConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.adam_mu_dtype == "bfloat16" else torch.float32


def init_adam(params: dict, cfg: RainbowConfig) -> AdamState:
    dev = next(iter(params.values())).device
    return AdamState(
        mu={k: torch.zeros_like(v, dtype=_mu_dtype(cfg))
            for k, v in params.items()},
        nu={k: torch.zeros_like(v) for k, v in params.items()},
        count=torch.zeros((), dtype=torch.int32, device=dev))


def init_agent(cfg: RainbowConfig, action_space: int, seed: int = 0,
               device="cuda") -> AgentState:
    """The params the JAX package's Trainer starts from for ``seed``
    (models.dqn.init_dqn_params, drawn on the host, so any device gets
    the same ones), a target copy, a fresh Adam state, the agent's generator
    on ``device`` and its noise stream."""
    dev = resolve_device(device)
    params = init_dqn_params(cfg, action_space, seed, dev)
    return AgentState(
        params=params,
        target_params={k: v.clone() for k, v in params.items()},
        opt_state=init_adam(params, cfg),
        generator=torch.Generator(device=dev).manual_seed(seed + 1),
        noise=NoiseStream(seed + 3))


def reset_noise(agent: AgentState, cfg: RainbowConfig, action_space: int,
                lead=()) -> dict:
    """A new set of noisy weights (reference agent.py:49-50; JAX
    agent.py:85-88 folds the noise key): the next draw of the agent's noise
    stream, which it advances, with leading shape ``lead``."""
    dev = next(iter(agent.params.values())).device
    return draw_noise(cfg, action_space, agent.noise, lead, dev)


def act(params: dict, cfg: RainbowConfig, action_space: int,
        states: torch.Tensor, noise: Optional[NoiseStream] = None,
        noise_eps: Optional[dict] = None) -> torch.Tensor:
    """Greedy batched action selection, argmax_a Σ_z z·p (reference
    agent.py:53-55), as (B,) int64. With cfg.per_env_noise each env row gets
    its own noise draw."""
    return forward_head(params, cfg, action_space, states, noise,
                        per_sample_noise=cfg.per_env_noise,
                        noise_eps=noise_eps).action


def act_e_greedy(params: dict, cfg: RainbowConfig, action_space: int,
                 states: torch.Tensor, generator: torch.Generator,
                 epsilon: float = 0.001) -> torch.Tensor:
    """ε-greedy evaluation policy (reference agent.py:58-59); the net runs
    μ only. ``generator`` draws the exploration on the states' device."""
    greedy = act(params, cfg, action_space, states)
    b, dev = greedy.shape[0], greedy.device
    rand = torch.randint(0, action_space, (b,), generator=generator,
                         device=dev)
    explore = torch.rand((b,), generator=generator, device=dev) < epsilon
    return torch.where(explore, rand, greedy)


def evaluate_q(params: dict, cfg: RainbowConfig, action_space: int,
               states: torch.Tensor) -> torch.Tensor:
    """Max expected Q per state (reference agent.py:110-112), batched, μ only."""
    return forward_head(params, cfg, action_space, states).max_q


def _loss_fn(params: dict, cfg: RainbowConfig, action_space: int,
             batch: dict, noise_eps: Optional[dict]):
    """(mean(w·loss), per-sample losses) (reference agent.py:126-134); the
    scalar is differentiable in ``params``."""
    v, a = loss_streams(params, cfg, action_space, batch["states"], noise_eps)
    losses, loss = head_loss(v, a, batch["actions"], batch["target_m"],
                             batch["weights"])
    return loss, losses


def compute_update_pretarget(agent: AgentState, cfg: RainbowConfig,
                             action_space: int, batch: dict,
                             pns_target: torch.Tensor,
                             noise_eps: Optional[dict] = None):
    """Gradient of one batch's loss, given this batch's slice ``pns_target``
    (B, A, atoms) of the round-wide target-net forward (JAX
    agent.py:177-209). Returns (grads {name: float32 tensor}, per-sample
    losses (B,) outside autograd).

    ``batch`` holds float ``states`` and ``next_states`` (B, 84, 84, H),
    ``actions``, ``returns``, ``nonterminals`` and ``weights`` (B,). The
    double-Q selection forward and the gradient forward share one online
    noise draw: ``noise_eps`` (models.dqn.draw_noise, shared over the
    batch), or a draw from the agent's noise stream."""
    if noise_eps is None:
        noise_eps = reset_noise(agent, cfg, action_space)
    support = support_vector(cfg.v_min, cfg.v_max, cfg.atoms,
                             pns_target.device)
    with torch.no_grad():
        a_star = forward_head(agent.params, cfg, action_space,
                              batch["next_states"], noise_eps=noise_eps,
                              support=support).action
        target_m = c51_target(pns_target, a_star, batch["returns"],
                              batch["nonterminals"],
                              cfg.discount ** cfg.multi_step, support,
                              cfg.v_min, cfg.v_max)
    leaves = {k: v.detach().requires_grad_() for k, v in agent.params.items()}
    loss, losses = _loss_fn(leaves, cfg, action_space,
                            dict(batch, target_m=target_m), noise_eps)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return dict(zip(leaves, grads)), losses


def compute_update(agent: AgentState, cfg: RainbowConfig, action_space: int,
                   batch: dict, draws: Optional[dict] = None):
    """Target construction and gradient for one batch, the sequential
    learner's update (JAX agent.py:137-174): the double-Q selection forward
    and the gradient forward with the online params share one online noise
    draw; the target forward uses a fresh target draw, shared over the
    batch. Both draws come from the agent's noise stream in one launch of
    the noise kernel, or from ``draws`` (``"online"``, ``"target"``:
    models.dqn.draw_noise dicts). ``batch`` as compute_update_pretarget's.
    Returns (grads, per-sample losses)."""
    draws = draws or {}
    online, target = draws.get("online"), draws.get("target")
    dev = batch["next_states"].device
    if online is None and target is None:
        online, target = draw_noise_sets(cfg, action_space, agent.noise,
                                         [(), ()], dev)
    elif online is None or target is None:
        raise ValueError("compute_update: draws holds both 'online' and "
                         "'target' noise, or neither")
    with torch.no_grad():
        pns_target = forward_head(agent.target_params, cfg, action_space,
                                  batch["next_states"], dist="probs",
                                  noise_eps=target).dist
    return compute_update_pretarget(agent, cfg, action_space, batch,
                                    pns_target, online)


def apply_grads_plain(params, grads, mu, nu, count: torch.Tensor, lr: float,
                      b1: float, b2: float, eps: float,
                      max_norm: float) -> None:
    """Plain version of the clip + Adam kernel: optax 0.2.6's
    clip_by_global_norm then scale_by_adam then scale(-lr), in its order of
    float32 ops, in place on the lists ``params``, ``mu``, ``nu`` and on
    ``count``. With a bfloat16 mu, optax's b1·mu is a bfloat16 product with
    b1 itself rounded to bfloat16, and mu_hat comes from the float32 mu
    before it is stored in bfloat16."""
    f32 = torch.float32
    norm = torch.sqrt(sum((g * g).sum() for g in grads))
    keep = norm < max_norm
    count.copy_(torch.where(count < 2 ** 31 - 1, count + 1, count))
    step = count.to(f32)
    bc1 = 1 - torch.pow(torch.tensor(b1, dtype=f32), step)
    bc2 = 1 - torch.pow(torch.tensor(b2, dtype=f32), step)
    b1_bf16 = torch.tensor(b1, dtype=torch.bfloat16)
    for p, g, m, v in zip(params, grads, mu, nu):
        g = torch.where(keep, g, (g / norm) * max_norm)
        decayed = (m * b1_bf16).to(f32) if m.dtype == torch.bfloat16 \
            else b1 * m
        m_new = (1 - b1) * g + decayed
        v_new = (1 - b2) * (g * g) + b2 * v
        u = (m_new / bc1) / (torch.sqrt(v_new / bc2) + eps)
        p.copy_(p + (-lr) * u)
        m.copy_(m_new)
        v.copy_(v_new)


def apply_grads(agent: AgentState, cfg: RainbowConfig, grads: dict) -> None:
    """Clip + Adam (reference agent.py:97-98; JAX agent.py:212-221) in
    place: one call of the clip + Adam kernel over all params on CUDA,
    its plain version on the CPU."""
    opt = agent.opt_state
    keys = list(agent.params)
    args = ([agent.params[k] for k in keys],
            [grads[k].contiguous() for k in keys],
            [opt.mu[k] for k in keys], [opt.nu[k] for k in keys], opt.count,
            cfg.learning_rate, ADAM_B1, ADAM_B2, cfg.adam_eps, cfg.norm_clip)
    if opt.count.is_cuda:
        k9.clip_adam(*args)
    else:
        apply_grads_plain(*args)
    agent.step += 1


def learn_step(agent: AgentState, rep: rp.ReplayState, cfg: RainbowConfig,
               action_space: int, beta, draws: Optional[dict] = None
               ) -> torch.Tensor:
    """One sequential learner step (JAX agent.py:226-245): a prioritized
    batch against the current priorities (``draws["u"]`` or the agent's
    generator), the update (compute_update, with ``draws``' noise if
    given), clip + Adam, and the write-back of the per-sample losses as
    priorities. Updates ``agent`` and ``rep`` in place; returns the mean
    loss as a 0-d device tensor."""
    draws = draws or {}
    batch = rp.sample(rep, beta, batch_size=cfg.batch_size,
                      history=cfg.history_length, n_step=cfg.multi_step,
                      discount=cfg.discount, generator=agent.generator,
                      u=draws.get("u"))
    grads, losses = compute_update(agent, cfg, action_space, batch, draws)
    apply_grads(agent, cfg, grads)
    rp.update_priorities(rep, batch["idxs"], losses, cfg.priority_exponent)
    return losses.mean()


def update_target(agent: AgentState) -> None:
    """Hard target sync (reference agent.py:102-103), in place."""
    for k, v in agent.params.items():
        agent.target_params[k].copy_(v)

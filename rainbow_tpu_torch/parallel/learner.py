"""The learner round over a list of shards (rainbow_tpu/parallel/learner.py:
44-177, and the single-device rounds of rainbow_tpu/train.py:351-448): both
rounds, batched PER and sequential PER, written once. One shard on one
device outside any process group is the single-device round
(train.learner_round).

Each shard is one replica of the agent and one replay shard, on one
device. A process holds one shard (a single-device run, or a rank of a
multi-process run on its device) or several (``cfg.data_parallel`` in one
process); the global index of local shard s is rank × local shards + s,
which takes the place of JAX's ``axis_index``. Every collective runs in
two steps: a reduction over the process's shards, then
``torch.distributed.all_reduce`` over the process group when the shards
join one (at any world size; at world size 1 it is the identity).

Over more than one shard the round is JAX's distributed one:

- each shard samples ``batch_size // shards`` rows from its own replay
  shard;
- IS weights are renormalised by the global max of the per-update
  ``weights_max``: ``w · (wmax / gmax)``;
- the gradients are averaged over all shards through one ``all_reduce``
  per update over one flat buffer of every gradient tensor, and every
  replica applies the identical clip + Adam update, so replicas stay
  bit-identical; the loss is averaged the same way;
- priorities are written back locally, then ``max_priority`` is reduced
  with a max over all shards that keeps a NaN (a NaN loss on one shard
  makes every shard's ``max_priority`` NaN, as JAX's ``pmax`` does; an
  all-reduce max alone may drop it, so an is-NaN flag rides beside it).

Draws. The online noise of each update is the same on every shard: a
process's replicas share one ``NoiseStream`` object, drawn once on the
first shard device, and every rank's stream advances by the same count.
The draws come from a source that follows the number of shards in all:

- one shard (``AgentDraws``): the single-device round's draws, the
  stratified uniforms from the agent's generator and the batched round's
  target noise with its online noise in one draw of the agent's stream;
- more than one (``ShardDraws``): the batched round's target noise (per
  row) and every round's uniforms per shard, from streams seeded by
  (cfg.seed, the global shard index, the agent's step at the round's
  start), so a shard's draws do not depend on which process holds it, and
  one process with two shards and two ranks with one shard each compute
  the same round.

The sequential round draws its target noise with the online noise from the
shared stream, one draw per update for every shard, as JAX's does (its
target key comes off the replicated ``agent.rng``). ``draws``, one dict per
local shard in train.learner_round's form, replaces any of them (the tests
replay JAX's draws this way).
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

from rainbow_tpu_torch import agent as ag
from rainbow_tpu_torch.config import RainbowConfig
from rainbow_tpu_torch.models.dqn import (draw_noise, draw_noise_sets,
                                          forward_head)
from rainbow_tpu_torch.models.noisy import NoiseStream
from rainbow_tpu_torch.parallel.mesh import world
from rainbow_tpu_torch.replay import prioritized as rp
from rainbow_tpu_torch.utils.logging import span

_M64 = (1 << 64) - 1
UNIFORMS, TARGET_NOISE = 0, 1  # the per-shard streams of shard_seed


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def shard_seed(seed: int, shard: int, step: int, stream: int) -> int:
    """The 63-bit seed of a per-shard stream (UNIFORMS or TARGET_NOISE) for
    the round that starts at agent step ``step`` on global shard
    ``shard``."""
    h = 0
    for x in (seed, shard, step, stream):
        h = _splitmix64(h ^ (x & _M64))
    return h >> 1


class Shards:
    """The shards of this process: its devices, one shard each, their place
    among all shards of the process group (``group``: join the initialized
    process group, if any; else the shards are all there is), and the two
    collectives of the round."""

    def __init__(self, devices: Sequence, cfg: RainbowConfig,
                 group: bool = True):
        self.devices = [torch.device(d) for d in devices]
        self.grouped = group and dist.is_available() and dist.is_initialized()
        self.rank, self.world = world() if group else (0, 1)
        self.count = self.world * len(self.devices)
        if cfg.batch_size % self.count:
            raise ValueError(f"batch_size {cfg.batch_size} must divide over "
                             f"{self.count} shards")
        self.batch = cfg.batch_size // self.count

    def index(self, s: int) -> int:
        """The global index of local shard ``s``."""
        return self.rank * len(self.devices) + s

    def mean(self, parts: List[torch.Tensor]) -> torch.Tensor:
        """The mean over all shards of one tensor per local shard, on the
        first shard device; may overwrite ``parts[0]``."""
        total = parts[0]
        for p in parts[1:]:
            total = total + p.to(total.device)
        if self.grouped:
            dist.all_reduce(total)
        return total / self.count if self.count > 1 else total

    def max(self, parts: List[torch.Tensor]) -> torch.Tensor:
        """The elementwise max over all shards of one tensor per local
        shard, on the first shard device, NaN wherever any shard has one."""
        top = parts[0] if len(parts) == 1 else torch.stack(
            [p.to(self.devices[0]) for p in parts]).amax(dim=0)
        if self.grouped:
            nan = torch.isnan(top)
            buf = torch.stack((torch.where(nan, float("-inf"), top),
                               nan.to(top.dtype)))
            dist.all_reduce(buf, op=dist.ReduceOp.MAX)
            top = torch.where(buf[1] > 0, float("nan"), buf[0])
        return top


class AgentDraws:
    """The draws of a round over one shard in all: the single-device
    round's, from the agent's generator and noise stream."""

    def __init__(self, agents, cfg: RainbowConfig, action_space: int,
                 shards: Shards):
        self.agent, self.cfg, self.a = agents[0], cfg, action_space
        self.dev = shards.devices[0]

    def generator(self, s: int) -> torch.Generator:
        return self.agent.generator

    def batched_noise(self, nl: int, bs: int):
        """(per-shard target noise, online noise) of a batched round."""
        target, online = draw_noise_sets(self.cfg, self.a, self.agent.noise,
                                         [(nl * bs,), (nl,)], self.dev)
        return [target], online


class ShardDraws:
    """The draws of a round over more than one shard: the uniforms and the
    batched round's target noise from per-shard streams (shard_seed), the
    online noise from the shared stream."""

    def __init__(self, agents, cfg: RainbowConfig, action_space: int,
                 shards: Shards):
        self.agents, self.cfg, self.a, self.shards = (agents, cfg,
                                                      action_space, shards)
        self.step = agents[0].step

    def _seed(self, s: int, stream: int) -> int:
        return shard_seed(self.cfg.seed, self.shards.index(s), self.step,
                          stream)

    def generator(self, s: int) -> torch.Generator:
        return torch.Generator(device=self.shards.devices[s]).manual_seed(
            self._seed(s, UNIFORMS))

    def batched_noise(self, nl: int, bs: int):
        online = draw_noise(self.cfg, self.a, self.agents[0].noise, (nl,),
                            self.shards.devices[0])
        return [draw_noise(self.cfg, self.a,
                           NoiseStream(self._seed(s, TARGET_NOISE)),
                           (nl * bs,), dev)
                for s, dev in enumerate(self.shards.devices)], online


def replicate(agent: ag.AgentState, devices: Sequence) -> list:
    """One replica of ``agent`` per device: copies of its params, target and
    Adam state, and the same step; every replica shares the agent's noise
    stream object. The first replica is ``agent`` itself when it lives on
    the first device."""
    out, home = [], agent.opt_state.count.device
    for i, dev in enumerate(devices):
        dev = torch.device(dev)
        if i == 0 and home.type == dev.type and dev.index in (None,
                                                              home.index):
            out.append(agent)
            continue
        cp = lambda d: {k: v.to(dev, copy=True) for k, v in d.items()}
        opt = agent.opt_state
        out.append(ag.AgentState(
            params=cp(agent.params), target_params=cp(agent.target_params),
            opt_state=ag.AdamState(mu=cp(opt.mu), nu=cp(opt.nu),
                                   count=opt.count.to(dev, copy=True)),
            generator=torch.Generator(device=dev).manual_seed(
                agent.generator.initial_seed()),
            step=agent.step, noise=agent.noise))
    return out


def _flat(grads: dict) -> torch.Tensor:
    return torch.cat([g.reshape(-1) for g in grads.values()])


def _unflat(flat: torch.Tensor, like: dict) -> dict:
    out, at = {}, 0
    for k, v in like.items():
        out[k] = flat[at:at + v.numel()].view(v.shape)
        at += v.numel()
    return out


def _to(eps: dict, dev) -> dict:
    return {k: (a.to(dev), b.to(dev)) for k, (a, b) in eps.items()}


def _apply_mean(agents, cfg: RainbowConfig, shards: Shards,
                grads: list) -> None:
    """Average the shards' gradients (one all-reduce over one flat buffer)
    and apply the same clip + Adam update on every replica; a lone shard
    applies its own."""
    if len(grads) == 1 and not shards.grouped:
        ag.apply_grads(agents[0], cfg, grads[0])
        return
    mean = shards.mean([_flat(g) for g in grads])
    for agent, dev in zip(agents, shards.devices):
        ag.apply_grads(agent, cfg, _unflat(mean.to(dev), agent.params))


def _renormalise(batches: list, wmaxs: list, shards: Shards, lead) -> None:
    """IS weights × wmax / gmax over more than one shard (``lead`` indexes
    wmax against the weights); one shard keeps its own."""
    if shards.count == 1:
        return
    gmax = shards.max(wmaxs)
    for b, wmax, dev in zip(batches, wmaxs, shards.devices):
        b["weights"] = b["weights"] * (wmax / gmax.to(dev))[lead]


def _sync_max_priority(reps, shards: Shards) -> None:
    top = shards.max([r.max_priority for r in reps])
    for r in reps:
        if top is not r.max_priority:
            r.max_priority.copy_(top.to(r.max_priority.device))


def distributed_round(agents: list, reps: list, cfg: RainbowConfig,
                      action_space: int, num_learns: int, beta,
                      shards: Shards,
                      draws: Optional[List[dict]] = None) -> torch.Tensor:
    """``num_learns`` learner updates over the local shards (``agents[s]``,
    ``reps[s]`` on ``shards.devices[s]``) and, through the process group,
    every other process's: the sequential PER round with
    cfg.sequential_per, else the batched one. Updates every replica and
    every replay shard's priorities and ``max_priority`` in place; returns
    the mean loss over all shards as a 0-d tensor on the first device."""
    n = len(shards.devices)
    if len(agents) != n or len(reps) != n:
        raise ValueError(f"distributed_round: {len(agents)} agents and "
                         f"{len(reps)} replay shards for {n} devices")
    draws = draws or [{} for _ in range(n)]
    source = (AgentDraws if shards.count == 1 else ShardDraws)(
        agents, cfg, action_space, shards)
    impl = _round_sequential if cfg.sequential_per else _round_batched
    return impl(agents, reps, cfg, action_space, num_learns, beta, shards,
                draws, source)


def _round_batched(agents, reps, cfg, action_space, nl, beta, shards,
                   draws, source) -> torch.Tensor:
    """The batched round (JAX train.py:351-418, learner.py:63-118): one
    stratified draw of the round's local batches per shard against the
    round-start priorities, the IS weights renormalised by the global
    per-update max, one target forward per shard over its round's rows
    with per-row noise, then per update the gradient on every shard, their
    mean, and the same clip + Adam on every replica; one write-back per
    shard at the end. Under a profiler its phases are the ranges
    ``rainbow.sample``, ``.target``, ``.update`` (one an update) and
    ``.write_back``."""
    bs, a = shards.batch, action_space
    bigs, wmaxs = [], []
    with span("sample"):
        for s, (rep, dev, d) in enumerate(zip(reps, shards.devices, draws)):
            u = d.get("u")
            if u is None:
                u = torch.rand((nl * bs,), generator=source.generator(s),
                               device=dev)
            big = rp.sample_many(rep, beta, num_batches=nl, batch_size=bs,
                                 history=cfg.history_length,
                                 n_step=cfg.multi_step,
                                 discount=cfg.discount, u=u)
            wmaxs.append(big.pop("weights_max"))
            bigs.append(big)
        _renormalise(bigs, wmaxs, shards, (slice(None), None))
    need = any(d.get(k) is None for d in draws for k in ("online", "target"))
    targets, online = [None] * len(agents), None
    pns, eps = [], []
    with span("target"):
        for s, (agent, dev, d, big) in enumerate(zip(agents, shards.devices,
                                                     draws, bigs)):
            ns = rp.states_to_float(big["next_states"].reshape(
                (nl * bs,) + big["next_states"].shape[2:]))
            if need and s == 0:
                # Drawn after the conversion: its temporary and the noise
                # alive together would raise the peak of allocated memory.
                targets, online = source.batched_noise(nl, bs)
            target = (d["target"] if d.get("target") is not None
                      else targets[s])
            with torch.no_grad():
                pns.append(forward_head(agent.target_params, cfg, a, ns,
                                        dist="probs", noise_eps=target)
                           .dist.view(nl, bs, a, cfg.atoms))
            del ns
            eps.append(d["online"] if d.get("online") is not None
                       else _to(online, dev))
    losses = [[] for _ in agents]
    for i in range(nl):
        with span("update"):
            grads = []
            for s, (agent, big) in enumerate(zip(agents, bigs)):
                batch = {k: big[k][i] for k in ("actions", "returns",
                                                "nonterminals", "weights")}
                batch["states"] = rp.states_to_float(big["states"][i])
                batch["next_states"] = rp.states_to_float(
                    big["next_states"][i])
                e = {k: (e_in[i], e_out[i]) for k, (e_in, e_out) in
                     eps[s].items()}
                g, l = ag.compute_update_pretarget(agent, cfg, a, batch,
                                                   pns[s][i], e)
                grads.append(g)
                losses[s].append(l)
            _apply_mean(agents, cfg, shards, grads)
    local = []
    with span("write_back"):
        for rep, big, ls in zip(reps, bigs, losses):
            ls = torch.stack(ls)
            rp.update_priorities(rep, big["idxs"], ls, cfg.priority_exponent)
            local.append(ls.mean())
        _sync_max_priority(reps, shards)
    return shards.mean(local)


def _round_sequential(agents, reps, cfg, action_space, nl, beta, shards,
                      draws, source) -> torch.Tensor:
    """The sequential round (JAX train.py:421-448, learner.py:120-163;
    reference agent.py:61-100 per update): per update, every shard samples
    against the priorities its previous update wrote, the IS weights are
    renormalised by the global max, the online and target noise are one
    shard writes back its priorities. Under a profiler each update's
    phases are the ranges ``rainbow.sample``, ``.update`` (its target
    forward inside) and ``.write_back``."""
    bs, a = shards.batch, action_space
    gens = [None] * len(agents)
    losses = [[] for _ in agents]
    for i in range(nl):
        batches = []
        with span("sample"):
            for s, (rep, dev, d) in enumerate(zip(reps, shards.devices,
                                                  draws)):
                if "u" in d:
                    u = d["u"][i]
                else:
                    if gens[s] is None:
                        gens[s] = source.generator(s)
                    u = torch.rand((bs,), generator=gens[s], device=dev)
                batches.append(rp.sample(rep, beta, batch_size=bs,
                                         history=cfg.history_length,
                                         n_step=cfg.multi_step,
                                         discount=cfg.discount, u=u))
            _renormalise(batches, [b["weights_max"] for b in batches],
                         shards, ())
        shared, grads, per = None, [], []
        with span("update"):
            for agent, dev, d, batch in zip(agents, shards.devices, draws,
                                            batches):
                if "online" in d:
                    nz = {k: {n: (x[i], y[i]) for n, (x, y) in d[k].items()}
                          for k in ("online", "target")}
                else:
                    if shared is None:
                        shared = draw_noise_sets(cfg, a, agents[0].noise,
                                                 [(), ()], shards.devices[0])
                    nz = {"online": _to(shared[0], dev),
                          "target": _to(shared[1], dev)}
                g, l = ag.compute_update(agent, cfg, a, batch, nz)
                grads.append(g)
                per.append(l)
            _apply_mean(agents, cfg, shards, grads)
        with span("write_back"):
            for rep, batch, l, ls in zip(reps, batches, per, losses):
                rp.update_priorities(rep, batch["idxs"], l,
                                     cfg.priority_exponent)
                ls.append(l.mean())
    with span("write_back"):
        _sync_max_priority(reps, shards)
    return shards.mean([torch.stack(ls).mean() for ls in losses])

"""Faults planted in the program underneath a run, for checking that the
comparison catches them (the CPU tests, and readings on the card with
``readings.py --fault``). Each takes ``patch(obj, name, new)``, which
replaces an attribute for the run and puts it back after."""
from __future__ import annotations


def unchanged(patch):
    """A step that returns its state unchanged: clip + Adam does nothing."""
    from rainbow_tpu_torch import agent

    def no_step(agent_state, cfg, grads):
        agent_state.step += 1
    patch(agent, "apply_grads", no_step)


def half_batch(patch):
    """Half of each batch left out of the loss, the mean taken over the
    rest."""
    from rainbow_tpu_torch import agent
    real = agent.head_loss

    def half(v, a, actions, m, weights):
        w = weights.clone()
        w[w.shape[0] // 2:] = 0
        return real(v, a, actions, m, 2 * w)
    patch(agent, "head_loss", half)


def leaf_unchanged(patch):
    """One small leaf, the value stream's last σ bias, left unchanged by
    clip + Adam while every other leaf moves."""
    from rainbow_tpu_torch import agent
    real = agent.apply_grads

    def skip_one(agent_state, cfg, grads):
        p = agent_state.params["fc_z_v.bias_sigma"]
        kept = p.clone()
        real(agent_state, cfg, grads)
        p.copy_(kept)
    patch(agent, "apply_grads", skip_one)


def priorities_permuted(patch):
    """The round's priorities written back to the drawn rows in reverse
    order within each batch: the same values, at the wrong rows."""
    from rainbow_tpu_torch.replay import prioritized
    real = prioritized.update_priorities

    def permuted(state, idxs, losses, priority_exponent):
        return real(state, idxs, losses.flip(-1), priority_exponent)
    patch(prioritized, "update_priorities", permuted)


def action_altered(patch):
    """The first env's action, where the act produces it, moved to the next
    action."""
    from rainbow_tpu_torch import train
    real = train.act_sharded

    def altered(agents, cfg, action_space, *rest, **kw):
        actions = real(agents, cfg, action_space, *rest, **kw).clone()
        actions[0] = (actions[0] + 1) % action_space
        return actions
    patch(train, "act_sharded", altered)


def frame_altered(patch):
    """One byte of the frame that the append writes into the ring, altered
    where it is written."""
    from rainbow_tpu_torch import train
    real = train._update_core

    def altered(cfg, stack, rep, *rest):
        col = int(rep.index)
        real(cfg, stack, rep, *rest)
        rep.frames[0, col, 0] ^= 1
    patch(train, "_update_core", altered)


def noise_untransformed(patch):
    """The noise drawn without its transform f(n) = sign(n)·√|n|: plain
    standard normals, where the draw produces them."""
    from rainbow_tpu_torch.models import dqn
    real = dqn.draw_scaled_noise

    def plain(stream, shapes, device="cuda"):
        return [t.sign() * t * t for t in real(stream, shapes, device)]
    patch(dqn, "draw_scaled_noise", plain)


FAULTS = {"unchanged": unchanged, "half_batch": half_batch,
          "leaf_unchanged": leaf_unchanged,
          "priorities_permuted": priorities_permuted,
          "action_altered": action_altered, "frame_altered": frame_altered,
          "noise_untransformed": noise_untransformed}

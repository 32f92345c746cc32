"""C51 distributional ops: the support, the projection of the Bellman target
onto it, the cross-entropy, and the learner's two fused entry points
(rainbow_tpu/ops/c51.py, rainbow_tpu/agent.py:126-134, 195-203).

The projection keeps the JAX package's dense triangular form

    m_j = Σ_i p_i · max(0, 1 − |b_i − j|)

which equals the reference's l/u scatter including its integer-b fix-ups
(an atom hit exactly keeps all its mass).

``c51_target`` (gather at the double-Q action a*, then the projection) and
``head_loss`` (dueling combine, log-softmax, gather at the taken action,
cross-entropy, IS-weighted mean, and the gradient into the streams) are one
launch each of the C51 kernels (kernels/c51.py) on CUDA tensors, and their
plain versions below on CPU tensors.
"""
from __future__ import annotations

import functools

import torch

from rainbow_tpu_torch.device import resolve_device
from rainbow_tpu_torch.kernels import c51 as k4


@functools.lru_cache(maxsize=None)
def _support(v_min: float, v_max: float, atoms: int,
             device: torch.device) -> torch.Tensor:
    return torch.linspace(v_min, v_max, atoms, dtype=torch.float32,
                          device=device)


def support_vector(v_min: float, v_max: float, atoms: int,
                   device="cuda") -> torch.Tensor:
    """z = linspace(V_min, V_max, atoms), float32 (reference agent.py:18).

    May differ from ``jnp.linspace`` in the last bit of some atoms: both
    round in float32, in different orders. Cached per device, so the
    returned tensor is shared: do not write to it.
    """
    return _support(float(v_min), float(v_max), atoms,
                    resolve_device(device))


def project_distribution(next_probs: torch.Tensor, returns: torch.Tensor,
                         nonterminals: torch.Tensor, discount_n: float,
                         support: torch.Tensor, v_min: float,
                         v_max: float) -> torch.Tensor:
    """(B, atoms) target probabilities at a*, (B,) n-step returns and (B,)
    float nonterminal masks → the (B, atoms) projected target m
    (reference agent.py:79-92): Tz = Rⁿ + γⁿ·z·nonterminal, clamped to
    [V_min, V_max], then spread over the two nearest atoms."""
    atoms = support.shape[0]
    delta_z = (v_max - v_min) / (atoms - 1)
    tz = returns[:, None] + nonterminals[:, None] * discount_n * support[None]
    b = (tz.clamp(v_min, v_max) - v_min) / delta_z
    j = torch.arange(atoms, dtype=b.dtype, device=b.device)
    w = (1.0 - (b[:, :, None] - j).abs()).clamp(0.0, 1.0)
    return torch.einsum("bi,bij->bj", next_probs, w)


def c51_loss(log_probs_a: torch.Tensor, target_m: torch.Tensor) -> torch.Tensor:
    """Per-sample cross-entropy −Σ_j m_j · log p_j (reference agent.py:94)."""
    return -(target_m * log_probs_a).sum(dim=1)


def c51_target_plain(pns_target: torch.Tensor, a_star: torch.Tensor,
                     returns: torch.Tensor, nonterminals: torch.Tensor,
                     discount_n: float, support: torch.Tensor, v_min: float,
                     v_max: float) -> torch.Tensor:
    """Plain version of the C51 target kernel."""
    rows = torch.arange(pns_target.shape[0], device=pns_target.device)
    return project_distribution(pns_target[rows, a_star.long()], returns,
                                nonterminals, discount_n, support, v_min,
                                v_max)


def c51_target(pns_target: torch.Tensor, a_star: torch.Tensor,
               returns: torch.Tensor, nonterminals: torch.Tensor,
               discount_n: float, support: torch.Tensor, v_min: float,
               v_max: float) -> torch.Tensor:
    """The double-Q target: the target net's (B, A, atoms) probabilities at
    the online net's greedy action a* (B,), projected onto the support.
    Returns m (B, atoms) float32, outside autograd."""
    if pns_target.is_cuda:
        return k4.c51_target(pns_target, a_star, returns, nonterminals,
                             discount_n, support, v_min, v_max)
    return c51_target_plain(pns_target, a_star, returns, nonterminals,
                            discount_n, support, v_min, v_max)


def head_loss_plain(v: torch.Tensor, a: torch.Tensor, actions: torch.Tensor,
                    m: torch.Tensor, weights: torch.Tensor):
    """Plain version of the C51 loss kernel: (per-sample losses (B,), the
    scalar mean(w·loss), dv, da), the gradients of the scalar into v (B,
    atoms) and a (B, A·atoms) in their dtype.

    The combine runs in the streams' dtype and the log-softmax in float32,
    as in the JAX package (models/dqn.py:148-153). With p the softmax at the
    taken action, the gradient into those logits is
    g = (w/B)·(p·Σm − m); dv = g and da_k = g·(δ_{k,a} − 1/A).
    """
    b, atoms = v.shape
    n_act = a.shape[1] // atoms
    aa = a.reshape(b, n_act, atoms)
    q = (v.reshape(b, 1, atoms) + aa - aa.mean(dim=1, keepdim=True))
    rows = torch.arange(b, device=v.device)
    log_p = torch.log_softmax(q.to(torch.float32), dim=2)[rows, actions.long()]
    losses = c51_loss(log_p, m)
    loss = (weights * losses).mean()
    g = (weights / b)[:, None] * (log_p.exp() * m.sum(dim=1, keepdim=True) - m)
    onehot = torch.nn.functional.one_hot(actions.long(), n_act).to(g.dtype)
    da = (onehot - 1.0 / n_act)[:, :, None] * g[:, None, :]
    return losses, loss, g.to(v.dtype), da.reshape(b, -1).to(a.dtype)


class _HeadLoss(torch.autograd.Function):
    """The loss and its gradient come from one launch (or one plain call) in
    forward; backward only scales the saved gradient."""

    @staticmethod
    def forward(ctx, v, a, actions, m, weights):
        fn = k4.head_loss if v.is_cuda else head_loss_plain
        losses, loss, dv, da = fn(v, a, actions, m, weights)
        ctx.save_for_backward(dv, da)
        ctx.mark_non_differentiable(losses)
        return losses, loss

    @staticmethod
    def backward(ctx, _d_losses, d_loss):
        dv, da = ctx.saved_tensors
        return (dv * d_loss.to(dv.dtype), da * d_loss.to(da.dtype), None,
                None, None)


def head_loss(v: torch.Tensor, a: torch.Tensor, actions: torch.Tensor,
              m: torch.Tensor, weights: torch.Tensor):
    """The learner's loss head (reference agent.py:126-134): returns
    (per-sample losses (B,) float32, outside autograd, and the scalar
    mean(w·loss)). ``v`` (B, atoms) and ``a`` (B, A·atoms) are the value and
    advantage streams in the compute dtype, ``actions`` (B,) the taken
    actions, ``m`` (B, atoms) the projected target, ``weights`` (B,) the IS
    weights. Differentiable in v and a."""
    return _HeadLoss.apply(v, a, actions, m, weights)

"""The network's operations: a forward pass of the torso (its multiply-adds
from its file, port_bench/reference/torsos/<architecture>.py) and the noisy
dueling C51 head (Kaixhin/Rainbow model.py's shapes), each noisy layer a μ
and a σ product, two operations a multiply-add; an update 5
forward-equivalents per sampled transition (the online forward, the
double-Q selection forward, the target forward, and a backward of about
two forwards); an act one forward per env-step."""
from port_bench.reference.rainbow import torso


def forward_flops(architecture: str, history: int, frame: int, hidden: int,
                  atoms: int, actions: int) -> int:
    t = torso(architecture)
    macs = t.macs(history, frame)
    flat = t.flat(history, frame)
    macs += 2 * (flat * hidden) * 2           # fc_h_v + fc_h_a, μ and σ
    macs += 2 * (hidden * atoms) + 2 * (hidden * actions * atoms)
    return 2 * macs


def iteration_flops(h, actions: int) -> int:
    """One Trainer iteration: its round's updates and its act."""
    f = forward_flops(h.architecture, h.history, h.frame, h.hidden, h.atoms,
                      actions)
    return (5 * h.learns_per_iter * h.batch_size + h.num_envs) * f

"""The network's operations: a forward pass of the Nature torso and the
noisy dueling C51 head (Kaixhin/Rainbow model.py's shapes), each noisy
layer a μ and a σ product, two operations a multiply-add; an update 5
forward-equivalents per sampled transition (the online forward, the
double-Q selection forward, the target forward, and a backward of about
two forwards); an act one forward per env-step."""
CONVS = {"canonical": ((32, 8, 4), (64, 4, 2), (64, 3, 1)),
         "data-efficient": ((32, 5, 5), (64, 5, 5))}


def forward_flops(architecture: str, history: int, frame: int, hidden: int,
                  atoms: int, actions: int) -> int:
    macs, s, cin = 0, frame, history
    for cout, k, st in CONVS[architecture]:
        s = (s - k) // st + 1
        macs += s * s * cout * k * k * cin
        cin = cout
    flat = s * s * cin
    macs += 2 * (flat * hidden) * 2           # fc_h_v + fc_h_a, μ and σ
    macs += 2 * (hidden * atoms) + 2 * (hidden * actions * atoms)
    return 2 * macs


def iteration_flops(h, actions: int) -> int:
    """One Trainer iteration: its round's updates and its act."""
    f = forward_flops(h.architecture, h.history, h.frame, h.hidden, h.atoms,
                      actions)
    return (5 * h.learns_per_iter * h.batch_size + h.num_envs) * f

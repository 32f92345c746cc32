"""The configurations that the port's checks on the card take their cases
from, in one place: the canonical preset at 1,024 envs and the other
presets that chip_smoke.py's Trainer runs drive (PRESET_RUNS), and each
cell of BENCHMARK.json as cli.main builds it (bench_cells); the calls each
of them makes of KA (noisy_layer_batches, ka_calls), K9's nets (adam_nets,
param_shapes) and K2's draws (noise_shapes); K9's digests on inputs from a
seed (adam_digests). tests/test_torch_port_cuda.py parametrises from these,
chip_smoke.py runs its Trainers and timing rows from them, and
tests/test_torch_port_impala.py checks them on the CPU.

Nothing here imports the port at module level: chip_smoke.py's timing
rows import the rainbow_tpu_torch of another tree after this module.
"""
import hashlib
import math

GAME, ENVS, SEED = "pong", 1024, 0
PONG_ACTIONS = 6  # the native engine's pong; --time-rows builds no engine

# The JAX package's other configurations (rainbow_tpu/config.py:174-224,
# BASELINE.json's first two), each through cli.main at the widths its
# preset publishes; chip_smoke.py's CUTS lists what was set beside them.
# Data-efficient (Atari-100k): 16 envs (docs/results_r1/README.md:10-14),
# the preset's whole ring (memory_capacity 100,000 = 16 x 6,250 columns,
# 706 MB of frames), hidden 256, n = 20, replay frequency 1 (16 updates of
# batch 32 an iteration), target update 2,000, lr 1e-4, from its own learn
# start: 100 warm-up iterations, then 101 rounds; one evaluation and a
# checkpoint at T = 3,200 with the replay-bearing save (--memory), which a
# new Trainer restores bit for bit.
DATA_EFFICIENT_ARGS = ["--preset", "data-efficient", "--game", "pong",
                       "--num-envs", "16", "--learn-start", "1600",
                       "--T-max", "3200", "--evaluation-interval", "3200",
                       "--checkpoint-interval", "3200", "--memory", "memory",
                       "--max-episode-length", "4000", "--id",
                       "chip_trainer_data_efficient", "--seed", "5"]
# Throughput: 1024 envs, the full 976-column ring (7.05 GB), rounds of 32
# updates of batch 256, lr 6.25e-5·√8; the schedule of TRAINER_ARGS (31
# warm-up iterations, 9 rounds), an evaluation and a checkpoint at the end,
# which a new Trainer restores bit for bit.
THROUGHPUT_ARGS = ["--preset", "throughput", "--num-envs", "1024",
                   "--learn-start", "32768", "--T-max", "40960",
                   "--evaluation-interval", "40960", "--checkpoint-interval",
                   "40960", "--max-episode-length", "4000", "--id",
                   "chip_trainer_throughput", "--seed", "6"]
# The canonical preset in bfloat16 with a bfloat16 Adam first moment
# (docs/results_r4/README.md:80-95): 4 rounds of 256 updates, an
# evaluation and a checkpoint at the end, which a new Trainer restores
# bit for bit (the bf16 mu as its uint16 bits).
BF16_ARGS = ["--num-envs", "1024", "--compute-dtype", "bfloat16",
             "--adam-mu-dtype", "bfloat16", "--learn-start", "32768",
             "--T-max", "35840", "--evaluation-interval", "35840",
             "--checkpoint-interval", "35840", "--max-episode-length",
             "4000", "--id", "chip_trainer_bf16", "--seed", "7"]
PRESET_RUNS = (("data-efficient", DATA_EFFICIENT_ARGS),
               ("throughput", THROUGHPUT_ARGS), ("bf16", BF16_ARGS))


def preset_configs():
    """PRESET_RUNS' configurations as cli.main builds them from their
    flags, by label."""
    from rainbow_tpu_torch.cli import parse_config

    return {label: parse_config(flags)[0] for label, flags in PRESET_RUNS}


def configs():
    """The canonical preset at ENVS envs and PRESET_RUNS' configurations,
    as [(label, configuration)]."""
    from rainbow_tpu_torch import canonical

    return [("canonical", canonical(game=GAME, num_envs=ENVS, seed=SEED)),
            *preset_configs().items()]


def bench_cells():
    """Each cell of BENCHMARK.json as (name, configuration), the
    configuration as cli.main builds it from the cell's files, through the
    benchmark's own reading of them (port_bench/harness): its architecture,
    envs, batch and round, its compute dtype and its Adam first moment."""
    from port_bench.harness.manifest import load_manifest, resolve
    from port_bench.harness.settings import cli_args
    from rainbow_tpu_torch.cli import parse_config

    manifest = load_manifest()
    out = []
    for w in manifest["workloads"]:
        r = resolve(manifest, w["name"])
        argv = cli_args(r["config"], r["traffic"], SEED, "chip_smoke")
        out.append((w["name"], parse_config(argv)[0]))
    return out


def noisy_layer_batches(cfgs, A, fwd):
    """KA's main-path launches of each configuration in ``cfgs``, as
    (B, noise modes, in, out, relu) per layer (fc_h with its ReLU, fc_z_v,
    fc_z_a), each shape once with the union of its modes, in order.
    Forward (``fwd``): the act over the envs, the evaluation's 10 episodes
    and 250-state validation chunks in every mode; the learner's batch with
    shared noise; the round's target forward over all of its rows with
    per-row noise. Backward: the learner's batch in every mode."""
    from rainbow_tpu_torch.models.dqn import _noisy_dims

    all_modes = ("mu", "shared", "row")
    out = {}
    for c in cfgs:
        rows = c.num_envs // c.replay_frequency * c.batch_size
        batches = ([(c.num_envs, all_modes), (10, all_modes),
                    (250, all_modes), (c.batch_size, ("shared",)),
                    (rows, ("row",))] if fwd
                   else [(c.batch_size, all_modes)])
        dims = _noisy_dims(c, A)
        layers = ((*dims["fc_h_v"], True), (*dims["fc_z_v"], False),
                  (*dims["fc_z_a"], False))
        for b, modes in batches:
            for n_in, n_out, relu in layers:
                key = (b, n_in, n_out, relu)
                have = out.get(key, ())
                out[key] = have + tuple(m for m in modes if m not in have)
    return [(b, modes, i, o, r) for (b, i, o, r), modes in out.items()]


def ka_calls(cfgs, cells, fwd):
    """KA's main-path calls as (shape, mode, dtype), each once: each
    configuration's layers at every batch and noise mode it calls KA with
    (noisy_layer_batches), in both dtypes for ``cfgs`` and in its own for
    each benchmark cell of ``cells``."""
    out = []
    for group, own in ((cfgs, False), (cells, True)):
        for _, c in group:
            dtypes = ((c.compute_dtype,) if own
                      else ("float32", "bfloat16"))
            for b, modes, n_in, n_out, _relu in noisy_layer_batches(
                    [c], PONG_ACTIONS, fwd):
                for case in (((b, n_in, n_out), m, d) for m in modes
                             for d in dtypes):
                    if case not in out:
                        out.append(case)
    return out


def param_shapes(cfg, A):
    """The shapes of ``cfg``'s net's param tensors, in the params' order
    (K9's tensors)."""
    from rainbow_tpu_torch.models import dqn

    return [tuple(s) for s in dqn.param_shapes(cfg, A).values()]


def noise_shapes(cfg, A, leads):
    """The tensors of one K2 launch that draws models.dqn.draw_noise's
    eight for each leading shape in ``leads``."""
    from rainbow_tpu_torch.models.dqn import _noisy_dims

    return [tuple(lead) + (d,) for lead in leads
            for dims in _noisy_dims(cfg, A).values() for d in dims]


def adam_nets(cfgs, cells):
    """K9's tensor lists: ragged small shapes, then the params of each net
    that ``cfgs`` and the benchmark's ``cells`` run (pong's actions), each
    net once under its first label: the canonical, the data-efficient and
    the IMPALA ResNet x4 nets (the last is 46 tensors in one call)."""
    nets = {"small": [(70, 301), (70,), (5000,), (3, 4, 5), (1,), (9000,)]}
    for label, c in list(cfgs) + list(cells):
        shapes = param_shapes(c, PONG_ACTIONS)
        if shapes not in nets.values():
            nets[label] = shapes
    return nets


def layout_cases(cells):
    """The configurations whose learner update is checked for layout
    conversions, {label: configuration}: the float32 Nature net at the
    learner's batch of 1,024 rows, and each benchmark cell whose torso is
    the IMPALA ResNet (it runs channels-last)."""
    from rainbow_tpu_torch import canonical
    from rainbow_tpu_torch.models import dqn

    out = {"canonical-float32": canonical(batch_size=1024)}
    out.update((name, c) for name, c in cells
               if isinstance(dqn.torso_of(c.architecture), dqn.ImpalaResNet))
    return out


ADAM_HYPER = (6.25e-5, 0.9, 0.999, 1.5e-4, 10.0)  # lr, b1, b2, eps, clip


def _views(torch, shapes, dtype, layout):
    """Zero tensors of ``shapes``: one each, or (``layout`` "flat") views
    of one flat buffer at the running offsets, as the data-parallel round
    hands K9 its gradients."""
    if layout != "flat":
        return [torch.zeros(s, dtype=dtype, device="cuda") for s in shapes]
    flat = torch.zeros(sum(math.prod(s) for s in shapes), dtype=dtype,
                       device="cuda")
    out, at = [], 0
    for s in shapes:
        out.append(flat[at:at + math.prod(s)].view(s))
        at += math.prod(s)
    return out


def adam_inputs(torch, shapes, mu_dtype=None, layout="separate"):
    """Params, grads, zero moments with a float32 mu (or ``mu_dtype``) and
    Adam's count for a net's ``shapes``, from a seed; with ``layout``
    "flat" the grads are views of one flat buffer, as the data-parallel
    round hands them to K9."""
    gp = torch.Generator(device="cuda").manual_seed(19)
    p = [torch.randn(s, generator=gp, device="cuda") * 0.05 for s in shapes]
    grads = _views(torch, shapes, torch.float32, layout)
    for t in grads:
        t.copy_(torch.randn(t.shape, generator=gp, device="cuda") * 1e-3)
    mu = [torch.zeros(s, dtype=mu_dtype, device="cuda") for s in shapes]
    nu = [torch.zeros(s, device="cuda") for s in shapes]
    return p, grads, mu, nu, torch.zeros((), dtype=torch.int32,
                                         device="cuda")


def sha256(torch, tensors):
    """The SHA-256 of the bits of ``tensors``, one after another."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().reshape(-1).cpu().view(torch.uint8)
                 .numpy().tobytes())
    return h.hexdigest()


def adam_digests(torch, shapes, mu_dtype=None, layout="separate"):
    """SHA-256 of what K9 leaves (params, mu and nu, each list's tensors in
    order, and count) after three steps through the imported wrapper from
    adam_inputs, with gradients from a seed of global norm about 0.26, 26
    and 0.26: below, above and below the clip."""
    from rainbow_tpu_torch.kernels.adam import clip_adam

    p, grads, mu, nu, count = adam_inputs(torch, shapes, mu_dtype, layout)
    n = sum(math.prod(s) for s in shapes)
    g = torch.Generator(device="cuda").manual_seed(20)
    for norm in (0.26, 26.0, 0.26):
        for t in grads:
            t.copy_(torch.randn(t.shape, generator=g, device="cuda")
                    * (norm / math.sqrt(n)))
        clip_adam(p, grads, mu, nu, count, *ADAM_HYPER)
    torch.cuda.synchronize()
    return {name: sha256(torch, ts)
            for name, ts in (("params", p), ("mu", mu), ("nu", nu),
                             ("count", [count]))}

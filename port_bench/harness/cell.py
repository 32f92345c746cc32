"""One run of one cell.

The run builds the Trainer through the program's entry point,
``rainbow_tpu_torch.cli.main``, with the cell's arguments, and finds the
Trainer's loop from outside: it wraps ``train.train_iter_sharded`` (one
call per Trainer iteration) and ``train.Trainer.run``; it edits no file of
the program. Inside ``Trainer.run`` the iterations go:

1. warm-up: the Trainer's own iterations before learn start, untouched;
2. checked: the first ``CHECKED_CALLS`` learning iterations take the
   benchmark's draws (the round's uniforms and noise, the act's noise),
   and the program's state is copied to the host around each of them, for
   the plain reference to follow once the window has closed;
3. settle: ``SETTLE_CALLS`` more learning iterations on the program's own
   draws, so that every shape of the cell has run;
4. the window: from the synchronised end of the last settle iteration to
   the synchronised end of the first iteration that ends ``--seconds``
   later; every iteration in between is counted whole;
5. with ``--trace 1``, ``TRACE_CALLS`` iterations more under
   ``torch.profiler``, with the harness's spans around the engine step and
   upload (``Trainer._stage``), the iteration's launch, the pipelined
   fetch and settle, and the tallies the per-layer metrics ask for;

then the wrapper sets the Trainer's T to its T-max, so that its loop ends
as it ends at the end of training.
"""
from __future__ import annotations

import contextlib
import gc
import importlib
import inspect
import sys
import time
from types import SimpleNamespace

import torch

from port_bench.harness import manifest as mf
from port_bench.harness import settings as st
from port_bench.harness import trace as tr
from port_bench.reference import check
from port_bench.reference import rainbow as ref

FORBIDDEN = ("jax", "jaxlib", "flax", "rainbow_tpu")
CHECKED_CALLS = 3
SETTLE_CALLS = 2
TRACE_CALLS = 40


def process_start() -> float:
    """The wall-clock time at which this process started (Linux), or now."""
    try:
        import os
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return time.time() - age
    except (OSError, ValueError, IndexError):
        return time.time()


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def _mix(seed: int, k: int) -> int:
    return (int(seed) * 1_000_003 + k) % (1 << 63)


def call_draws(h: ref.Hyper, actions: int, seed: int, k: int, device):
    """The benchmark's draws for checked call ``k``: the program's
    ``draws`` dict (the round's uniforms, per-row target noise and
    per-update online noise) and the act's noise."""
    g = torch.Generator(device=device).manual_seed(_mix(seed, k + 1))
    nb, bs = h.learns_per_iter, h.batch_size
    u = torch.rand((nb * bs,), generator=g, device=device)
    target = ref.draw_noise(h, actions, g, (nb * bs,), device)
    online = ref.draw_noise(h, actions, g, (nb,), device)
    lead = (h.num_envs,) if h.per_env_noise else ()
    act = ref.draw_noise(h, actions, g, lead, device)
    return {"u": u, "target": target, "online": online}, act


def weights(h: ref.Hyper, actions: int, seed: int, device) -> dict:
    g = torch.Generator(device=device).manual_seed(_mix(seed, 0))
    return ref.init_params(h, actions, g, device)


def _host(t):
    return t.detach().to("cpu", copy=True)


def snapshot(agent, rep, stack, first: bool, col: int = None) -> dict:
    """The program's state, copied to the host."""
    opt = agent.opt_state
    s = {"agent": {"params": {k: _host(v) for k, v in agent.params.items()},
                   "target": {k: _host(v)
                              for k, v in agent.target_params.items()},
                   "mu": {k: _host(v) for k, v in opt.mu.items()},
                   "nu": {k: _host(v) for k, v in opt.nu.items()},
                   "count": int(opt.count)},
         "ring": {k: _host(getattr(rep, k)) for k in (
             "priorities", "max_priority", "actions", "rewards", "timesteps",
             "nonterminal", "t")},
         "stack": _host(stack)}
    s["ring"]["index"], s["ring"]["full"] = int(rep.index), bool(rep.full)
    if first:
        written = rep.frames.shape[1] if bool(rep.full) else int(rep.index)
        s["frames"] = _host(rep.frames[:, :written])
    else:
        s["col"], s["col_frames"] = col, _host(rep.frames[:, col])
    return s


def _patch(obj, name, new, undo: list):
    undo.append((obj, name, getattr(obj, name)))
    setattr(obj, name, new)


def _span(name, fn):
    def wrapped(*a, **kw):
        with torch.profiler.record_function("port_bench." + name):
            return fn(*a, **kw)
    return wrapped


class _SpannedFuture:
    """A future whose ``result`` is a span (the pipelined fetch's wait)."""

    def __init__(self, fut):
        self._fut = fut

    def result(self, *a, **kw):
        with torch.profiler.record_function("port_bench.fetch"):
            return self._fut.result(*a, **kw)

    def __getattr__(self, name):
        return getattr(self._fut, name)


class Driver:
    """The wrapper of ``train.train_iter_sharded`` and its phases."""

    def __init__(self, run):
        self.run = run
        self.n_check = CHECKED_CALLS
        self.n_settle = SETTLE_CALLS
        self.n_trace = TRACE_CALLS
        self.phase = "warmup"
        self.count = 0
        self.iteration = 0
        self.snaps, self.calls = [], []
        self.window_losses = []
        self.trainer = None
        self.undo_trace = []
        self.prof = None
        self.win_span = None

    # -- helpers -----------------------------------------------------------
    def _sync(self):
        if self.run.device.type == "cuda":
            torch.cuda.synchronize(self.run.device)

    def _stop_loop(self):
        self.trainer.T = self.trainer.cfg.total_steps
        self.phase = "done"

    def _start_window(self):
        self._sync()
        self.t0 = time.perf_counter()
        self.t0_wall = time.time()
        self.timer0 = dict(self.trainer.timer.totals)
        self.phase, self.count = "window", 0

    # -- the wrapper -------------------------------------------------------
    def wrap(self, real):
        sig = inspect.signature(real)

        def wrapper(*args, **kw):
            self.iteration += 1
            if self.phase == "window":
                return self._window(real, args, kw)
            if self.phase == "trace":
                return self._traced(real, args, kw)
            if self.phase in ("warmup", "check"):
                ba = sig.bind(*args, **kw)
                ba.apply_defaults()
                if ba.arguments["num_learns"] == 0 and self.phase == "warmup":
                    return real(*args, **kw)
                self.phase = "check"
                return self._checked(real, ba)
            if self.phase == "settle":
                out = real(*args, **kw)
                self.count += 1
                if self.count >= self.n_settle:
                    self._start_window()
                return out
            return real(*args, **kw)
        return wrapper

    def _checked(self, real, ba):
        a = ba.arguments
        k = len(self.calls)
        agent, rep, stack = a["agents"][0], a["reps"][0], a["stacks"][0]
        if k == 0:
            self.program_act_noise = {n: tuple(_host(t) for t in pair)
                                      for n, pair in a["act_noise"].items()}
            self.snaps.append(snapshot(agent, rep, stack, True))
        col = int(rep.index)
        draws, act = call_draws(self.run.hyper, self.run.actions,
                                self.run.seed, k, self.run.device)
        tail = a["tails"][0]
        if len(tail) != 6:
            raise RuntimeError("the checked calls need dense uploads")
        names = ("obs", "reset_packed", "reset_idx", "rewards", "dones",
                 "kinds")
        step = {n: _host(t) for n, t in zip(names, tail)}
        step["prev_actions"] = _host(a["prev_actions"])
        call = {"iteration": self.iteration,
                "program_beta": float(a["beta"]),
                "program_num_learns": int(a["num_learns"]),
                "program_sync": bool(a["sync_target"]), "step": step}
        a["act_noise"], a["draws"] = act, [draws]
        actions, loss = real(*ba.args, **ba.kwargs)
        call["out"] = {"actions": _host(actions), "loss": float(loss)}
        del draws, act
        self.snaps.append(snapshot(agent, rep, stack, False, col))
        self.calls.append(call)
        if len(self.calls) >= self.n_check:
            if self.run.seconds is None:
                self._stop_loop()
            else:
                self.phase, self.count = "settle", 0
        return actions, loss

    def _window(self, real, args, kw):
        out = real(*args, **kw)
        self.count += 1
        self.window_losses.append(out[1])
        if time.perf_counter() - self.t0 >= self.run.seconds:
            self._sync()
            t1 = time.perf_counter()
            self.window = {
                "iterations": self.count, "seconds": t1 - self.t0,
                "env_steps": self.count * self.run.hyper.num_envs,
                "setup_s": self.t0_wall - self.run.started,
                "timer": {k: v - self.timer0.get(k, 0.0)
                          for k, v in self.trainer.timer.totals.items()},
                "memory_peak_bytes": (torch.cuda.max_memory_allocated(
                    self.run.device) if self.run.device.type == "cuda"
                    else 0)}
            if self.run.trace:
                self._trace_start()
            else:
                self._stop_loop()
        return out

    def _traced(self, real, args, kw):
        with torch.profiler.record_function("port_bench.iteration"):
            out = real(*args, **kw)
        self.count += 1
        if self.count >= self.n_trace:
            self._sync()
            self.win_span.__exit__(None, None, None)
            self.prof.__exit__(None, None, None)
            for obj, name, old in reversed(self.undo_trace):
                setattr(obj, name, old)
            self.trace = tr.read_profile(self.prof)
            self.prof = None
            self._stop_loop()
        return out

    def _trace_start(self):
        from torch.profiler import ProfilerActivity, profile

        from rainbow_tpu_torch.train import Trainer
        undo = self.undo_trace
        _patch(Trainer, "_stage", _span("stage", Trainer._stage), undo)
        _patch(Trainer, "_settle", _span("settle", Trainer._settle), undo)
        fetch = Trainer._fetch
        _patch(Trainer, "_fetch",
               lambda tr_, pool, a: _SpannedFuture(fetch(tr_, pool, a)),
               undo)
        self.tallies = {}
        for metric, mod in self.run.readers.items():
            for module, fn_name, key in getattr(mod, "TALLY", ()):
                counts = self.tallies.setdefault(metric, {})
                target = importlib.import_module(module)
                _patch(target, fn_name,
                       _tally(getattr(target, fn_name), key, counts), undo)
        acts = [ProfilerActivity.CPU]
        if self.run.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.win_span = torch.profiler.record_function(tr.WINDOW_SPAN)
        self.win_span.__enter__()
        self.phase, self.count = "trace", 0


def _tally(fn, key, counts):
    def wrapped(*a, **kw):
        k = key(*a, **kw)
        counts[k] = counts.get(k, 0) + 1
        return fn(*a, **kw)
    return wrapped


def run_cell(cell: str, seed: int, seconds, trace: bool, device="cuda",
             control: ref.Precision = None, bench=mf.BENCH,
             started: float = None) -> dict:
    """One run of ``cell``; ``seconds=None`` stops after the checked calls
    (no window). Returns {"result": the result line's object or None,
    "readings": the numbers, "checks": each beside its limit, "window":
    the window's iterations, seconds and Trainer timer totals}."""
    started = process_start() if started is None else started
    manifest = mf.load_manifest(bench.parent)
    files = mf.resolve(manifest, cell, bench)
    config, traffic = files["config"], files["traffic"]
    h = st.hyper(config, traffic)
    dev = torch.device(device)
    run = SimpleNamespace(seed=seed, seconds=seconds, trace=trace,
                          device=dev, traffic=traffic, hyper=h,
                          started=started, actions=None,
                          readers={m["name"]: mf.load_metric(m["name"], bench)
                                   for m in files["per_layer"]}
                          if trace else {})
    tf32 = bool(config.get("tf32", False))
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32

    from rainbow_tpu_torch import cli
    from rainbow_tpu_torch import train as tm

    driver = Driver(run)
    undo = []
    real_run = tm.Trainer.run

    def run_patched(trainer):
        driver.trainer = trainer
        run.actions = trainer.action_space
        shapes = ref.param_shapes(h, trainer.action_space)
        for k, v in trainer.agent.params.items():
            if tuple(v.shape) != shapes.get(k):
                raise RuntimeError(f"parameter {k}: the program's shape "
                                   f"{tuple(v.shape)}, the configuration's "
                                   f"{shapes.get(k)}")
        w = weights(h, trainer.action_space, seed, dev)
        for agent in trainer.agents:
            for k, v in w.items():
                agent.params[k].copy_(v)
                agent.target_params[k].copy_(v)
        run.weights = {k: _host(v) for k, v in w.items()}
        del w
        return real_run(trainer)

    _patch(tm, "train_iter_sharded", driver.wrap(tm.train_iter_sharded), undo)
    _patch(tm.Trainer, "run", run_patched, undo)
    argv = st.cli_args(config, traffic, seed, "port_bench")
    try:
        with contextlib.redirect_stdout(sys.stderr):
            trainer = cli.main(argv, device=device)
    finally:
        for obj, name, old in reversed(undo):
            setattr(obj, name, old)
    if len(driver.calls) < driver.n_check:
        raise RuntimeError(f"the Trainer ended after {len(driver.calls)} "
                           f"checked calls of {driver.n_check}")
    if seconds is not None and not hasattr(driver, "window"):
        raise RuntimeError("the Trainer ended before the window did")
    losses = (torch.stack(driver.window_losses).cpu()
              if driver.window_losses else torch.zeros(0))
    driver.window_losses = []
    del trainer
    driver.trainer = None
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    prec = ref.Precision(torch.bfloat16 if h.compute_dtype == "bfloat16"
                         else torch.float32)
    calls = [dict(c, inputs=None) for c in driver.calls]
    for k, c in enumerate(calls):
        draws, act = call_draws(h, run.actions, seed, k, dev)
        _t, _l, beta, _nl, sync = ref.schedule(h, c["iteration"])
        c["inputs"] = {"beta": float(torch.tensor(beta, dtype=torch.float32)),
                       "sync_target": sync, "draws": draws,
                       "act_noise": act,
                       "step": {n: t.to(dev) for n, t in c["step"].items()}}
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    got = check.readings(driver.snaps, calls, h, run.actions, prec,
                         files["limits"]["tie"], dev, control)
    got["program"].update(check.start_and_noise(
        driver.snaps, calls, run.weights, h, driver.program_act_noise))
    limits = files["limits"]["limits"]
    checks = {n: {"value": got["program"][n], "limit": limits[n]}
              for n in check.NUMBERS}
    out = {"readings": got, "checks": checks, "result": None}
    if seconds is None:
        return out
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    w = driver.window
    metrics = {}
    if not trace:
        rate = w["env_steps"] / w["seconds"]
        values = {"train_env_steps_per_s": rate, "setup_s": w["setup_s"]}
        for m in files["end_to_end"]:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    else:
        ctx = SimpleNamespace(settings=st.merged(config, traffic), hyper=h,
                              actions=run.actions, window=w,
                              trace=driver.trace,
                              tallies=getattr(driver, "tallies", {}))
        for m in files["per_layer"]:
            v = run.readers[m["name"]].read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device_info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                 else "cpu"),
        "count": 1, "memory_peak_bytes": w["memory_peak_bytes"]}
    result = {"correct": correct, "attempted": w["iterations"],
              "failed": int((~torch.isfinite(losses)).sum()),
              "metrics": metrics, "device": device_info}
    if trace:
        device_info["busy_s"] = driver.trace["busy_s"]
        device_info["window_s"] = driver.trace["window_s"]
        result["breakdown"] = tr.breakdown(driver.trace)
    result["checks"] = checks
    out["result"], out["window"] = result, w
    return out

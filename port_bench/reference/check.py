"""The comparison that decides ``correct``: the calls that the program made
on the benchmark's inputs, worked out again by the plain reference from
the program's state at each call's start, and the numbers that compare
them, each against its limit.

Each number is the largest over the checked calls:

- ``start``: elements that differ, at the first checked call's start,
  between the program's weights and target and the benchmark's weights,
  its Adam moments and count and zero, and, at every checked call, its
  schedule (β, updates, target sync) and the reference's. Exact.
- ``noise``: the program's own act noise at the first checked call, drawn
  by it, in standard errors: the larger of |mean(ε)| and
  |mean(ε²) − √(2/π)|, each over its standard error (for f(n) =
  sign(n)·√|n| of standard normals, mean 0, E[ε²] = E|n| = √(2/π) and
  Var(ε²) = 1 − 2/π).
- ``loss``: |L − L_ref| / |L_ref| of the call's mean loss.
- ``mu``: over the parameter tensors ("leaves"), the median leaf's
  |‖μ‖ − ‖μ_ref‖| / max(‖μ_ref‖, the median leaf's ‖μ_ref‖) of Adam's first
  moment after the call: the gradients as the optimizer holds them.
- ``mu_worst``: the same of the worst leaf. A near-tie of the double-Q
  argmax moves one row's target within rounding and a small leaf's
  gradient by far more, so its limit is looser than the median's; a leaf
  left unmoved or moved double reads about 1.
- ``change``, ``change_worst``: the same of each leaf's change over the
  call, leaving out leaves whose gradient in the reference's first update
  is under a thousandth of the median leaf's (they move by round-off
  alone).
- ``priorities``: ‖P − P_ref‖ / ‖P_ref − P_before‖ over the whole ring,
  element by element, leaving out the rows whose double-Q margin in the
  reference is under the cell's ``tie`` (there rounding may pick the other
  action, and the row's target and priority move by far more) and, where
  such a row's priority may be the round's largest on either side, the
  appended column, which takes the largest priority.
- ``append``: elements that differ in the ring's written column, its head,
  its episode counters and the frame stack. Exact.
- ``act``: over the envs, the largest gap by which the reference's Q of
  the action taken lies below the reference's best Q.
"""
from __future__ import annotations

import math
import statistics
from typing import Dict, List

import torch

from port_bench.reference import rainbow as ref

NUMBERS = ("start", "noise", "loss", "mu", "mu_worst", "change",
           "change_worst", "priorities", "append", "act")


def _dev(tree, device):
    if isinstance(tree, dict):
        return {k: _dev(v, device) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.to(device, copy=True)
    return tree


def state_at(snaps: List[dict], k: int, device) -> dict:
    """The program's state at the start of checked call ``k`` (0-based), on
    ``device``: the snapshot after call k − 1 (or before the first), with
    the ring's frames rebuilt from the first snapshot's written columns
    and every later call's appended column."""
    s = snaps[k]
    frames = snaps[0]["frames"]
    for later in snaps[1:k + 1]:
        col, add = later["col"], later["col_frames"]
        if col >= frames.shape[1]:
            frames = torch.cat([frames, frames.new_zeros(
                (frames.shape[0], col + 1 - frames.shape[1],
                 frames.shape[2]))], 1)
        frames = frames.clone()
        frames[:, col] = add
    ring = dict(_dev(s["ring"], device), frames=frames.to(device, copy=True))
    ring["index"], ring["full"] = int(s["ring"]["index"]), bool(
        s["ring"]["full"])
    agent = _dev(s["agent"], device)
    agent["count"] = int(s["agent"]["count"])
    return {"agent": agent, "ring": ring,
            "stack": s["stack"].to(device, copy=True)}


def produced_by_program(snaps: List[dict], k: int, out: dict) -> dict:
    """What checked call ``k`` produced in the program: its state after
    the call and the call's returned actions and loss."""
    s = snaps[k + 1]
    return {"params": s["agent"]["params"], "mu": s["agent"]["mu"],
            "priorities": s["ring"]["priorities"],
            "column": s["col_frames"], "ring": s["ring"], "stack": s["stack"],
            "actions": out["actions"], "loss": float(out["loss"])}


def produced_by_reference(state: dict, out: dict, col: int) -> dict:
    ring, agent = state["ring"], state["agent"]
    return {"params": agent["params"], "mu": agent["mu"],
            "priorities": ring["priorities"],
            "column": ring["frames"][:, col],
            "ring": {k: ring[k] for k in ("actions", "rewards", "timesteps",
                                          "nonterminal", "t")}
            | {"index": ring["index"], "full": ring["full"]},
            "stack": state["stack"], "actions": out["q"].argmax(1),
            "loss": float(out["loss"])}


def _norms(d: dict) -> Dict[str, float]:
    return {k: float(v.detach().double().norm()) for k, v in d.items()}


def _leaf_gaps(a: Dict[str, float], b: Dict[str, float],
               keys) -> Dict[str, float]:
    keys = list(keys)
    floor = statistics.median(b[k] for k in keys)
    return {k: abs(a[k] - b[k]) / max(b[k], floor, 1e-30) for k in keys}


def _priorities(pp, pr, pb, before_max: float, res: dict, col: int,
                tie: float):
    """``priorities`` (see the module's docstring) and the rows left out."""
    idx, margins = res["idx"].reshape(-1), res["margins"].reshape(-1)
    tied = margins < tie
    keep = torch.ones_like(pr, dtype=torch.bool)
    if bool(tied.any()):
        keep.view(-1)[idx[tied]] = False
        rest = pr.view(-1)[idx[~tied]]
        top = max(before_max, float(rest.max()) if rest.numel() else 0.0)
        t_idx = idx[tied]
        if max(float(pp.view(-1)[t_idx].max()),
               float(pr.view(-1)[t_idx].max())) >= top:
            keep[:, col] = False
    gap = float((pp - pr)[keep].norm() / (pr - pb).norm().clamp(min=1e-30))
    return gap, int(tied.sum())


def compare(prod: dict, refd: dict, before: dict, res: dict, col: int,
            tie: float, dev):
    """The numbers of one call (all but ``start`` and ``noise``), the
    leaves left out of ``change``, the worst leaf of each of ``mu`` and
    ``change`` and the rows left out of ``priorities``."""
    mu = _leaf_gaps(_norms({k: v.float() for k, v in prod["mu"].items()}),
                    _norms({k: v.float() for k, v in refd["mu"].items()}),
                    refd["mu"])
    p0 = before["agent"]["params"]
    d_prod = _norms({k: prod["params"][k].to(dev) - p0[k]
                     for k in p0})
    d_ref = _norms({k: refd["params"][k] - p0[k] for k in p0})
    grad_norms = res["grad_norms"]
    med = statistics.median(grad_norms.values())
    moved = [k for k in p0 if grad_norms[k] >= 1e-3 * med]
    change = _leaf_gaps(d_prod, d_ref, moved)
    excluded = sorted(set(p0) - set(moved))
    worst = {"mu": max(mu, key=mu.get), "change": max(change, key=change.get)}
    pri, tied = _priorities(
        prod["priorities"].to(dev).double(), refd["priorities"].double(),
        before["ring"]["priorities"].double(),
        float(before["ring"]["max_priority"]), res, col, tie)
    diff = int((prod["column"].to(dev) != refd["column"]).sum())
    for k in ("actions", "rewards", "timesteps", "nonterminal"):
        diff += int((prod["ring"][k].to(dev)[:, col]
                     != refd["ring"][k][:, col]).sum())
    diff += int((prod["ring"]["t"].to(dev) != refd["ring"]["t"]).sum())
    diff += int(int(prod["ring"]["index"]) != int(refd["ring"]["index"]))
    diff += int(bool(prod["ring"]["full"]) != bool(refd["ring"]["full"]))
    diff += int((prod["stack"].to(dev) != refd["stack"]).sum())
    q_ref = res["q"]
    rows = torch.arange(q_ref.shape[0], device=dev)
    act = float((q_ref.max(1).values
                 - q_ref[rows, prod["actions"].to(dev).long()]).max())
    loss = abs(prod["loss"] - refd["loss"]) / max(abs(refd["loss"]), 1e-30)
    return {"loss": loss, "mu": statistics.median(mu.values()),
            "mu_worst": max(mu.values()),
            "change": statistics.median(change.values()),
            "change_worst": max(change.values()), "priorities": pri,
            "append": float(diff), "act": act}, excluded, worst, tied


def start_and_noise(snaps: List[dict], calls: List[dict], weights: dict,
                    h: ref.Hyper, act_noise: dict) -> Dict[str, float]:
    """``start`` and ``noise`` (see the module's docstring)."""
    s0 = snaps[0]["agent"]
    diff = 0
    for k, w in weights.items():
        w = w.cpu()
        diff += int((s0["params"][k] != w).sum())
        diff += int((s0["target"][k] != w).sum())
        diff += int((s0["mu"][k] != 0).sum()) + int((s0["nu"][k] != 0).sum())
    diff += int(int(s0["count"]) != 0)
    for call in calls:
        _t, _l, beta, nl, sync = ref.schedule(h, call["iteration"])
        diff += int(float(call["program_beta"]) != float(_f32(beta)))
        diff += int(call["program_num_learns"] != nl)
        diff += int(bool(call["program_sync"]) != bool(sync))
    eps = torch.cat([t.reshape(-1).double() for pair in act_noise.values()
                     for t in pair])
    n, m2 = eps.numel(), math.sqrt(2 / math.pi)
    noise = max(abs(float(eps.mean())) / math.sqrt(m2 / n),
                abs(float((eps * eps).mean()) - m2)
                / math.sqrt((1 - 2 / math.pi) / n))
    return {"start": float(diff), "noise": noise}


def _f32(x: float) -> float:
    return float(torch.tensor(x, dtype=torch.float32))


def readings(snaps: List[dict], calls: List[dict], h: ref.Hyper,
             actions: int, prec: ref.Precision, tie: float, device,
             control: ref.Precision = None) -> Dict[str, Dict[str, float]]:
    """The numbers of the program against the reference in ``prec`` and,
    with ``control``, of the reference in the control's precision put in
    the program's place: {"program": {...}, "control": {...}}, with the
    leaves left out of ``change``, the worst leaves, the smallest double-Q
    margin and the most rows left out of ``priorities`` in a call."""
    out = {"program": {}, "control": {}, "excluded": [],
           "min_margin": float("inf"), "tied_rows": 0,
           "worst": {"program": {}, "control": {}}}
    for k, call in enumerate(calls):
        before = state_at(snaps, k, device)
        col = before["ring"]["index"]
        state = state_at(snaps, k, device)
        res = ref.follow_call(state, call["inputs"], h, actions, prec)
        out["min_margin"] = min(out["min_margin"],
                                float(res["margins"].min()))
        refd = produced_by_reference(state, res, col)
        sides = {"program": produced_by_program(snaps, k, call["out"])}
        if control is not None:
            cstate = state_at(snaps, k, device)
            cres = ref.follow_call(cstate, call["inputs"], h, actions,
                                   control)
            sides["control"] = produced_by_reference(cstate, cres, col)
        for side, prod in sides.items():
            got, excluded, worst, tied = compare(prod, refd, before, res,
                                                 col, tie, device)
            out["excluded"] = sorted(set(out["excluded"]) | set(excluded))
            out["tied_rows"] = max(out["tied_rows"], tied)
            for name, v in got.items():
                if v >= out[side].get(name, 0.0):
                    out[side][name] = v
                    if name.endswith("_worst"):
                        out["worst"][side][name] = worst[name[:-6]]
        del state, before, res, refd, sides
    if control is None:
        del out["control"], out["worst"]["control"]
    return out

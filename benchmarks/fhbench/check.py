"""The numbers that decide ``correct``, each against the limit of its
cell's ``limits/<workload>.json``.

A training cell's numbers compare what the program's first steps and its
window produced with what the plain reference computes from the same corpus
and the same initial weights:

- ``loss_gap``: the largest relative gap of a step's loss over the first
  three steps (one eager step, then the first two of the first K-step
  dispatch, which runs eagerly);
- ``first_loss_gap``: the relative gap of the first step's loss alone, the
  forward pass over the initial weights; steady from seed to seed, where the
  second and third steps' losses swing with Adam's first update (which
  moves each element by about the learning rate, on the sign of its
  gradient, so an element whose gradient round-off can flip moves the other
  way on one side);
- ``replay_loss_gap``: the same over the K steps of the second dispatch,
  the first replay of the captured CUDA graph (the trajectories have drifted
  apart by round-off there, so it is held against faults, not precision);
- ``grad_gap``: the first step's gradient as the optimizer got it, worked
  out from Adam's first moment after one step (``mu / (1 - b1)``), by the
  worst leaf: the gap between the two norms of a leaf over the larger of the
  reference's norm of that leaf and of the median leaf;
- ``update_gap``: the same of each leaf's change over the first steps,
  leaving out the leaves whose reference gradient is under a thousandth of
  the median leaf's (they move by round-off alone under Adam);
- ``table_gap`` (hierarchical rounds): the round's MAP-initialised table
  after the first step, by the worst row: the norm of the row's difference
  over the median row's norm; a wrong draw or a wrong MAP pass moves whole
  rows;
- ``dev_lb_gap``: the relative gap of the last epoch's dev lower bound, the
  program's against the reference's dev pass over the program's final
  weights;
- ``window_draw_gap`` (hierarchical rounds): the share of the window's last
  round's sequences, in the program's order, that differ from the
  reference's draw for that epoch (exact: its limit is 0);
- ``window_table_gap`` (hierarchical rounds): that round's MAP-initialised
  table by the worst row, as ``table_gap``, against the reference's MAP
  init over its own draw from the weights the program held at the
  turnover.
"""

from __future__ import annotations

import numpy as np

FLOOR = 1e-3  # a leaf's reference gradient under FLOOR x the median leaf's


def _norms(tree: dict) -> dict:
    return {n: float(np.linalg.norm(np.asarray(v, np.float64)))
            for n, v in tree.items()}


def leaf_gap(prog: dict, ref: dict, keep=None) -> float:
    """The worst leaf's gap between its two norms over the larger of the
    reference's norm of it and of the median leaf."""
    names = [n for n in ref if keep is None or n in keep]
    p, r = _norms({n: prog[n] for n in names}), _norms({n: ref[n]
                                                        for n in names})
    median = float(np.median(list(r.values())))
    return max(abs(p[n] - r[n]) / max(r[n], median, 1e-30) for n in names)


def row_gap(prog, ref) -> float:
    """The worst row's norm of the difference of two tables over the
    median row norm of the reference's; ``inf`` where their shapes
    differ."""
    tp, tr = np.asarray(prog, np.float64), np.asarray(ref, np.float64)
    if tp.shape != tr.shape:
        return float("inf")
    rows = np.linalg.norm(tr, axis=1)
    return float(np.max(np.linalg.norm(tp - tr, axis=1))
                 / max(np.median(rows), 1e-30))


def draw_gap(prog: list, ref: list) -> float:
    """The share of positions at which two draws of keys differ (1 where
    their lengths differ)."""
    if len(prog) != len(ref):
        return 1.0
    return float(np.mean([a != b for a, b in zip(prog, ref)]))


def numbers(prog: dict, ref: dict, b1: float, k: int) -> dict:
    """The cell's numbers from the program's readings ``prog`` and the
    reference's ``ref`` (see the module docstring for their keys) over the
    first ``1 + 2 k`` steps (``k`` steps a dispatch)."""
    lp, lr = np.asarray(prog["losses"]), np.asarray(ref["losses"])
    if lp.shape != lr.shape or len(lr) != 1 + 2 * k:
        return {"loss_gap": float("inf"), "first_loss_gap": float("inf")}
    gaps = np.abs(lp - lr) / np.abs(lr)
    out = {"loss_gap": float(np.max(gaps[:3])),
           "first_loss_gap": float(gaps[0]),
           "replay_loss_gap": float(np.max(gaps[1 + k:])),
           "loss_gaps": gaps.tolist()}
    g_prog = {n: m / (1.0 - b1) for n, m in prog["mu_first"].items()}
    out["grad_gap"] = leaf_gap(g_prog, ref["first_grads"])
    g_ref = _norms(ref["first_grads"])
    median = float(np.median(list(g_ref.values())))
    moving = {n for n, v in g_ref.items() if v >= FLOOR * median}
    out["update_gap"] = leaf_gap(
        {n: prog["params_after"][n] - prog["params_before"][n]
         for n in moving},
        {n: ref["params_after"][n] - ref["params_before"][n]
         for n in moving})
    if "table_first" in ref:
        out["table_gap"] = row_gap(prog["table_first"], ref["table_first"])
    if "dev_lb" in prog and "dev_lb" in ref:
        out["dev_lb_gap"] = abs(prog["dev_lb"] - ref["dev_lb"]) \
            / abs(ref["dev_lb"])
    return out


def judge(values: dict, limits: dict) -> tuple[bool, list]:
    """``(correct, [(name, value, limit), ...])``: every number the limits
    name must be finite and within its limit; a number not computed
    fails."""
    rows, ok = [], True
    for name, spec in limits.items():
        value = values.get(name, float("nan"))
        passed = bool(np.isfinite(value) and value <= spec["limit"])
        ok &= passed
        rows.append((name, value, spec["limit"]))
    return ok, rows

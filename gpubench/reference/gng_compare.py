"""The comparison that decides ``correct`` for the GNG cells.

It judges as ``compare`` does (``start``, ``own``, ``step`` and
``frozen`` cases, ``step_gap`` under ``compare.STEP_GAP_LIMIT`` and
``checked_share`` over ``compare.CHECKED_SHARE_FLOOR``), with the plain
GNG reference (``gng_step``) in place of the SOAM one, and its near
ties (distances, and the order of the errors where the insertion reads
it) left out.

The error field is compared relative to the network's largest error:
errors are sums of squared distances decayed by d ** survivors every
iteration, so their scale moves by orders of magnitude within a job
(tens early, 1e-4 late), while every other float is a point of the
unit-scale surface. A gap of the errors counts ``|a - b|`` over the
largest ``|a|`` or ``|b|`` of the network; every other field counts as
in ``compare.state_gap``.
"""
from __future__ import annotations

import dataclasses

import torch

from gpubench.reference import compare
from gpubench.reference import gng_step as ref

STEP_GAP_LIMIT = compare.STEP_GAP_LIMIT
CHECKED_SHARE_FLOOR = compare.CHECKED_SHARE_FLOOR
Tally = compare.Tally


def state_gap(got: ref.Net, want: ref.Net) -> tuple[float, str]:
    """(gap, the field that sets it) between two states of one network."""
    gap, field = compare.state_gap(got.replace(error=want.error), want)
    if field not in (*compare.CONTINUOUS, "none"):
        return gap, field                    # a discrete disagreement
    act = want.active
    a, b = got.error[act].double(), want.error[act].double()
    if a.numel() == 0:
        return gap, field
    scale = float(torch.maximum(a.abs().max(), b.abs().max()))
    g = float((a - b).abs().max()) / scale if scale > 0 else 0.0
    if not g == g:          # nan, inf
        return 1.0, "error"
    return (g, "error") if g > gap else (gap, field)


def judge_network(tally: Tally, p: ref.Params, cap: dict,
                  program=None) -> None:
    """Judge one network of one job; ``cap`` and ``program`` as in
    ``compare.judge_network``."""
    states = {k: ref.Net.of(v) for k, v in cap["states"].items()}
    drawn = set(cap["drawn"])
    inputs = cap["inputs"]

    def judged(k, before):
        if program is None:
            return states[k + 1]
        return program(before, *inputs[k], k) if k in drawn else before

    C, K = states[0].nbr.shape
    own = ref.init(cap["seed_points"], C, K, p.insertion_threshold)
    tally.add("start", *state_gap(states[0], own))
    side, first_tie, judged_n = states[0], None, 0
    for k in range(cap["trajectory"]):
        side = judged(k, side)
        want, tie = (ref.step(own, *inputs[k], k, p) if k in drawn
                     else (own, False))
        if tie:
            tally.add("own", None)
            first_tie = k if first_tie is None else first_tie
            own = side
            continue
        tally.add("own", *state_gap(side, want))
        judged_n += 1
        own = want
    if cap["trajectory"]:
        tally.trajectories.append((
            cap["trajectory"] if first_tie is None else first_tie,
            judged_n))
    for t in cap["steps"]:
        before = states[t]
        if t not in drawn:
            tally.add("frozen", *state_gap(judged(t, before), before))
            continue
        want, tie = ref.step(before, *inputs[t], t, p)
        tally.add("step", *((None,) if tie else
                            state_gap(judged(t, before), want)))


def control_step(p: ref.Params):
    """The control: the reference itself with its distance product in
    TF32, the nearest precision below the configuration's float32."""
    def run(net, x, prio, t):
        return ref.step(net, x, prio, t, p, tf32=True)[0]
    return run


# planted faults, each put in the program's place as the control is:
# alpha 0.45 for 0.5, and each insertion at the unit of the second
# largest error
FAULTS = ("alpha", "second_worst")


def fault_step(p: ref.Params, fault: str):
    if fault not in FAULTS:
        raise ValueError(f"unknown fault {fault!r}; {FAULTS}")
    if fault == "alpha":
        q = dataclasses.replace(p, gng_alpha=0.45)
        return lambda net, x, prio, t: ref.step(net, x, prio, t, q)[0]
    return lambda net, x, prio, t: ref.step(net, x, prio, t, p,
                                            fault=fault)[0]

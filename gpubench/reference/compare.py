"""The comparison that decides ``correct`` for the GSON cells.

The program's states are judged against the plain reference
(``gson_step``), from the inputs the benchmark drew:

  start    the reference builds its own fresh network from the seed
           points and must equal the program's state before iteration
           0;
  own      from there the reference runs its own trajectory, and after
           every iteration up to the traffic's ``trajectory_iterations``
           its state must equal the program's. At an iteration that held
           a near tie (below) the two may part soundly: that iteration
           is left out, and the reference goes on from the program's
           state after it;
  step     from the program's state before a sampled later iteration t,
           the reference runs iteration t and must reach the program's
           state before iteration t + 1;
  frozen   a network that did not draw iteration t (converged or
           quarantined) must be left as it was.

The number compared is ``step_gap``: the widest gap between the two
states over the active units (weights, firing counters, thresholds,
errors), where any discrete disagreement (which units are active, the
edge sets with their whole-number ages, the state ladder, the counters)
counts as a gap of 1, the radius of the sampled surfaces. A case in
which the reference met a near tie (``gson_step.D2_TIE``,
``FIRING_TIE``) is left out, and ``checked_share``, the share of cases
compared, has to stay above its floor so that the check never runs
empty. The readings these limits were set from are in ``PERF.md``.
"""
from __future__ import annotations

import torch

from gpubench.reference import gson_step as ref

# sound runs read 5.96e-08 (one float32 ulp of a unit weight) on every
# seed; a discrete disagreement (the TF32 control, every planted fault)
# reads 1
STEP_GAP_LIMIT = 1e-3
# near ties leave out 0-8% of the cases of a sound run
CHECKED_SHARE_FLOOR = 0.5

COUNTERS = ("n_active", "signal_count", "discarded", "dropped_edges",
            "dropped_units")
CONTINUOUS = ("w", "firing", "threshold", "error")


def state_gap(got: ref.Net, want: ref.Net) -> tuple[float, str]:
    """(gap, the field that sets it) between two states of one network."""
    if not torch.equal(got.active, want.active):
        return 1.0, "active"
    for f in COUNTERS:
        if int(getattr(got, f)) != int(getattr(want, f)):
            return 1.0, f
    act = want.active
    for f in ("topo_state", "inconsistent_for"):
        if not torch.equal(getattr(got, f)[act].long(),
                           getattr(want, f)[act].long()):
            return 1.0, f
    g_nbr, g_i = got.nbr[act].long().sort(dim=1)
    w_nbr, w_i = want.nbr[act].long().sort(dim=1)
    if not torch.equal(g_nbr, w_nbr):
        return 1.0, "nbr"
    if not torch.equal(torch.where(g_nbr >= 0, got.age[act].gather(1, g_i),
                                   0.0),
                       torch.where(w_nbr >= 0, want.age[act].gather(1, w_i),
                                   0.0)):
        return 1.0, "age"
    gap, field = 0.0, "none"
    for f in CONTINUOUS:
        a, b = getattr(got, f)[act], getattr(want, f)[act]
        if a.numel() == 0:
            continue
        g = float((a.double() - b.double()).abs().max())
        if not g == g:          # nan
            return 1.0, f
        if g > gap:
            gap, field = g, f
    return gap, field


class Tally:
    """Cases judged, cases left out as near ties, and the widest gap with
    the case and field that set it."""

    def __init__(self):
        self.compared = 0
        self.ties = 0
        self.step_gap = 0.0
        self.worst = "none"
        # per network with an own trajectory: (iterations run before its
        # first near tie, iterations it judged)
        self.trajectories: list = []

    def add(self, kind: str, gap: float | None, field: str = "") -> None:
        if gap is None:
            self.ties += 1
            return
        self.compared += 1
        if gap >= self.step_gap:
            self.step_gap, self.worst = gap, f"{kind}:{field}"

    @property
    def checked_share(self) -> float:
        total = self.compared + self.ties
        return self.compared / total if total else 0.0

    def numbers(self) -> list:
        """[(name, value, limit, sense)]: sense "max" holds value <= limit,
        "min" value >= limit."""
        return [("step_gap", self.step_gap, STEP_GAP_LIMIT, "max"),
                ("checked_share", self.checked_share, CHECKED_SHARE_FLOOR,
                 "min")]

    @property
    def correct(self) -> bool:
        return all(v <= lim if sense == "max" else v >= lim
                   for _, v, lim, sense in self.numbers())


def judge_network(tally: Tally, p: ref.Params, cap: dict,
                  program=None) -> None:
    """Judge one network of one job. ``cap``: ``seed_points`` (n, d),
    ``states`` {k: the program's state before iteration k}, ``inputs``
    {k: (signals, priorities)}, ``drawn`` (the iterations it drew),
    ``trajectory`` (the iterations of its own trajectory, 0 for none),
    ``steps`` (the sampled t). ``program``: for the control, a function
    (state, signals, priorities, t) -> state that takes the program's
    place, from the program's state before iteration 0 and before each
    sampled t."""
    states = {k: ref.Net.of(v) for k, v in cap["states"].items()}
    drawn = set(cap["drawn"])
    inputs = cap["inputs"]

    def judged(k, before):
        """The judged side's state after iteration k from ``before``."""
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

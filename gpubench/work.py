"""Counted work of the GSON iteration, and the H100's published peaks.

The counts come from what the algorithm needs for one network in one
iteration, never from the program's buffer shapes:

  m   live signals (the m-schedule: Find Winners runs on these alone)
  a   active units before the iteration
  s   lock survivors (signals whose winner they keep)
  e   edges before the iteration (each counted once); g = 2 e / a the
      mean degree
  C   the pool's slots, d the dimension, K the neighbor slots per unit
  r   SOAM state-ladder refreshes in the iteration (0, 1 or 2)

Each input byte is counted read once and each output byte written once;
intermediates of a phase stay on chip. Floats are 4 bytes, ids 4 bytes,
flags 1 byte.

  Find Winners (B1)
    flops  m a (3d - 1)        d differences, d squares, d - 1 sums per
                               (signal, active unit) pair
    bytes  4 d m + 4 d a + C + 12 m
                               signals, active weights, the pool's
                               active flags; winner id, second id and
                               winner distance out
  Update phase (B2 lock, B3 pulls and habituation, B4 edge aging)
    flops  s (3d + 4 + g (3d + 6))
                               per survivor: winner pull (3d + 1),
                               habituation (3); per neighbor: pull
                               (3d + 1), habituation (3), both ages (2)
    bytes  m (4d + 16) + s (8d + 12 + 12K) + u (8d + 12) + 8 s g
                               signals, winner, second, distance and
                               priority of every live signal; per
                               survivor its weights and firing read and
                               written, its threshold and ladder state,
                               its neighbor row and ages (ages written);
                               per distinct neighbor unit, u = min(s g,
                               a), its weights and firing read and
                               written and its ladder state; the mirrored
                               age of each winner edge read and written
  The whole iteration (the share of peak, ``mfu``)
    flops  the two phases' flops
    bytes  4 d m + 4 m + 2 a (4d + 8K + 21) + C + r a g 4 K
                               signals and priorities in; each active
                               unit's state (weights, K neighbor ids and
                               ages, error, firing, threshold, ladder
                               state, stuck counter, active flag) read
                               once and written once; the active flags of
                               the pool; per refresh, each active unit's
                               neighbors' rows (the link graphs)

A least time is the larger of flops over the float32 peak and bytes over
the HBM peak; a share of a roofline or of the peak is that least time
over a measured time, and cannot pass 100% unless the count is too high
or the time leaves out part of the work.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense, no sparsity, at the 700 W limit
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12


def find_winners(m: int, a: int, C: int, d: int) -> tuple[float, float]:
    """(flops, bytes) of B1 for one network."""
    return (float(m * a * (3 * d - 1)),
            float(4 * d * m + 4 * d * a + C + 12 * m))


def _degree(a: int, e: int) -> float:
    return 2.0 * e / a if a else 0.0


def update_phase(m: int, s: int, a: int, e: int, d: int,
                 K: int) -> tuple[float, float]:
    """(flops, bytes) of B2-B4 for one network."""
    g = _degree(a, e)
    u = min(s * g, float(a))
    flops = s * (3 * d + 4 + g * (3 * d + 6))
    nbytes = (m * (4 * d + 16) + s * (8 * d + 12 + 12 * K)
              + u * (8 * d + 12) + 8 * s * g)
    return float(flops), float(nbytes)


def iteration(m: int, s: int, a: int, e: int, C: int, d: int, K: int,
              refreshes: int) -> tuple[float, float]:
    """(flops, bytes) of the whole iteration for one network."""
    g = _degree(a, e)
    flops = find_winners(m, a, C, d)[0] + update_phase(m, s, a, e, d, K)[0]
    nbytes = (4 * d * m + 4 * m + 2 * a * (4 * d + 8 * K + 21) + C
              + refreshes * a * g * 4 * K)
    return float(flops), float(nbytes)


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the chip needs for this work at its peaks."""
    return max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES)

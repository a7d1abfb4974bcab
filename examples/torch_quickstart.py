"""Quickstart of the PyTorch/CUDA port: a session, a checkpoint, a fleet.

  PYTHONPATH=src python examples/torch_quickstart.py            # the card
  PYTHONPATH=src python examples/torch_quickstart.py --device cpu

Reconstructs a sphere with a multi-signal SOAM session, checkpoints it
halfway, restores it from disk and finishes it (the restored run emits
the same rows as the uninterrupted one would), then runs a small fleet of
networks through one batched program and checks one of them against its
own session. The twin of ``examples/quickstart.py`` (the JAX package).
"""
import argparse
import tempfile

import torch

from repro_torch import gson
from repro_torch.core.gson import metrics
from repro_torch.core.gson.state import GSONParams

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
ap.add_argument("--iters", type=int, default=400)
ap.add_argument("--fleet", type=int, default=4, help="networks in the fleet")
args = ap.parse_args()

spec = gson.RunSpec(
    variant="multi",
    model=GSONParams(model="soam", insertion_threshold=0.35, age_max=64.0,
                     eps_b=0.1, eps_n=0.01, stuck_window=60),
    sampler="sphere",
    variant_config=gson.MultiConfig(refresh_every=2),
    capacity=512, max_deg=16, check_every=25, max_iterations=args.iters,
    device=args.device)

# --- 1. a session, checkpointed halfway and restored from disk ---------
with tempfile.TemporaryDirectory() as ckpt_dir:
    sess = gson.Session(spec, seed=0, checkpoint_dir=ckpt_dir)
    sess.run(budget=args.iters // 2)
    sess.checkpoint()
    print(f"checkpointed at iteration {sess.iteration}: "
          f"{int(sess.state.n_active)} units")
    del sess                                   # the process goes away
    sess = gson.Session.restore(spec, ckpt_dir)
    for row in sess.stream():
        print(f"  it={row['iteration']:5d} units={row['units']:5d} "
              f"qe={row['qe']:.5f}")
state, stats = sess.result()
v, e, f, chi = metrics.euler_characteristic(state)
print(f"sphere: units={stats.units} edges={stats.connections} "
      f"signals={stats.signals} converged={stats.converged}; "
      f"V-E+F = {v}-{e}+{f} = {chi} (sphere: 2)")

# --- 2. a fleet: several networks, one batched program ------------------
fleet = gson.FleetSession(gson.FleetSpec.broadcast(
    spec.replace(max_iterations=100), seeds=range(args.fleet)))
fleet.run()
for i, (st, s) in enumerate(fleet.results()):
    print(f"  network {i}: units={s.units} qe={s.quantization_error:.5f}")
alone = gson.Session(spec.replace(max_iterations=100), seed=1)
alone.run()
same = torch.equal(alone.state.nbr, fleet.network(1).nbr)
print(f"fleet of {args.fleet}: network 1 equals its own session: {same}")

"""repro_torch.gson — the composable run API of the port.

The counterpart of ``repro.gson``: assemble a run from names (or
objects) along four registered axes, then drive it as a streaming,
resumable session, or as a fleet of B networks stepped together.

    from repro_torch import gson

    spec = gson.RunSpec(variant="multi-fused", model="soam",
                        sampler="sphere", backend="cuda-full",
                        capacity=4096, max_iterations=1500)

    state, stats = gson.run(spec, seed=42)            # one-shot

    sess = gson.Session(spec, seed=42)                # streaming
    for row in sess.stream(budget=500):               # pause at 500 iters
        print(row["iteration"], row["qe"])
    sess.resume()                                     # ... to convergence
    state, stats = sess.result()

    fleet = gson.FleetSession(gson.FleetSpec.broadcast(spec, seeds=range(8)))
    fleet.run()                                       # 8 networks at once
    state3, stats3 = fleet.result(3)                  # == Session(spec, seed=3)

Runs go on the card unless ``RunSpec(device="cpu")``; on a CPU tensor
every kernel wrapper runs its plain PyTorch version.

Registries: ``VARIANTS`` (single / indexed / multi / multi-fused;
``single`` and ``indexed`` are the paper's sequential baselines and run as
a ``Session`` only), ``MODELS`` (gng / gwr / soam), ``SAMPLERS`` (the
benchmark surfaces), ``BACKENDS`` (reference / cuda / cuda-update /
cuda-full: per-phase Hopper kernels for Find Winners and the dense Update
phase; cuda-sparse: the Update kernels on the winner-neighborhood slab;
cuda-auto: per shape the fastest Update phase of the selection table
measured on the card, ``repro_torch.gson.autotune``; ann-windowed /
ann-grid / indexed: the approximate searches of ``repro_torch.ann`` with
the reference Update phase, ``ann_backend`` at another recall target).

Distributed execution is one more declarative knob, ``MeshSpec`` (paper
Sec. 2.5's taxonomy) over the ranks of a ``torch.distributed`` group, one
process per device, every rank running the same code:
``FleetSpec(..., mesh=gson.MeshSpec(axis="network"))`` shards a fleet's
networks across the ranks, and
``RunSpec(mesh=gson.MeshSpec(axis="signal"))`` shards one network's
signal batch (the paper's data partitioning).

Fault injection (``repro_torch.gson.faults``): ``checkpoint_crash``,
``poison_network``, ``FaultySampler``, ``lowering_failure_backend`` and
the serving schedule ``GsonFaultInjector``, as in the JAX package; and
``ElasticFleetRunner`` (``repro_torch.gson.elastic``), which shrinks a
network-sharded fleet's mesh on a lost pod and reshard-restores it.
"""
from repro_torch.core.gson.state import GSONParams, NetworkState
from repro_torch.core.gson.superstep import SuperstepConfig
from repro_torch.gson.elastic import ElasticFleetRunner
from repro_torch.gson.faults import (DeviceLossError, FaultySampler,
                                     GsonFaultInjector, SimulatedCrash,
                                     checkpoint_crash,
                                     lowering_failure_backend,
                                     poison_network)
from repro_torch.gson.fleet import FleetSession, FleetSpec, run_fleet
from repro_torch.gson.registry import (BACKENDS, MODELS, SAMPLERS, VARIANTS,
                                       Backend, ModelDef, Registry,
                                       ann_backend, resolve_backend,
                                       resolve_model, resolve_sampler)
from repro_torch.gson.session import RunStats, Session, run
from repro_torch.gson.spec import MeshSpec, RunSpec, resolve, resolve_variant
from repro_torch.gson.variants import (DEFAULT_BBOX, FusedConfig,
                                       IndexedConfig, MultiConfig, Runtime,
                                       SingleConfig, VariantStrategy,
                                       check_convergence)
from repro_torch.rng import TorchDraws

__all__ = [
    "BACKENDS", "DEFAULT_BBOX", "MODELS", "SAMPLERS", "VARIANTS",
    "Backend", "DeviceLossError", "ElasticFleetRunner", "FaultySampler",
    "FleetSession", "FleetSpec", "FusedConfig", "GSONParams",
    "GsonFaultInjector", "IndexedConfig", "MeshSpec", "ModelDef",
    "MultiConfig", "NetworkState", "Registry", "RunSpec", "RunStats",
    "Runtime", "Session", "SimulatedCrash", "SingleConfig",
    "SuperstepConfig", "TorchDraws", "VariantStrategy", "ann_backend",
    "check_convergence", "checkpoint_crash", "lowering_failure_backend",
    "poison_network", "resolve", "resolve_backend", "resolve_model",
    "resolve_sampler", "resolve_variant", "run", "run_fleet",
]

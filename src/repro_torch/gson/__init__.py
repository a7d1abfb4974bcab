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

Registries: ``VARIANTS`` (multi / multi-fused), ``MODELS`` (gng / gwr /
soam), ``SAMPLERS`` (the benchmark surfaces), ``BACKENDS`` (reference /
cuda / cuda-update / cuda-full: per-phase Hopper kernels for Find
Winners and the dense Update phase).
"""
from repro_torch.core.gson.state import GSONParams, NetworkState
from repro_torch.core.gson.superstep import SuperstepConfig
from repro_torch.gson.fleet import FleetSession, FleetSpec, run_fleet
from repro_torch.gson.registry import (BACKENDS, MODELS, SAMPLERS, VARIANTS,
                                       Backend, ModelDef, Registry,
                                       resolve_backend, resolve_model,
                                       resolve_sampler)
from repro_torch.gson.session import RunStats, Session, run
from repro_torch.gson.spec import RunSpec, resolve, resolve_variant
from repro_torch.gson.variants import (FusedConfig, MultiConfig, Runtime,
                                       VariantStrategy)
from repro_torch.rng import TorchDraws

__all__ = [
    "BACKENDS", "MODELS", "SAMPLERS", "VARIANTS",
    "Backend", "FleetSession", "FleetSpec", "FusedConfig", "GSONParams",
    "ModelDef", "MultiConfig", "NetworkState", "Registry", "RunSpec",
    "RunStats", "Runtime", "Session", "SuperstepConfig",
    "TorchDraws", "VariantStrategy", "resolve",
    "resolve_backend", "resolve_model", "resolve_sampler",
    "resolve_variant", "run", "run_fleet",
]

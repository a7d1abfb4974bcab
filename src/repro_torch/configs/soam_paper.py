"""The paper's own configuration: SOAM surface reconstruction.

The port's ``repro.configs.soam_paper``: the multi-signal variant with m
capped at 8192 (paper Sec. 3.1) on a pool of 32768 units of degree 16.

``paper_spec()`` expresses the experiment as a ``repro_torch.gson``
``RunSpec``; like every ``RunSpec`` of the port it runs on the card
through the ``cuda-full`` kernels unless the caller replaces ``device``
or ``backend``.
"""
from repro_torch.core.gson.state import GSONParams

config = GSONParams(
    model="soam",
    eps_b=0.05,
    eps_n=0.005,
    age_max=30.0,
    insertion_threshold=0.25,
    max_parallel=8192,
)

# the production-scale pool: 32k units, degree 16
CAPACITY = 65536 // 2
MAX_DEG = 16
DIM = 3


def paper_spec(surface: str = "sphere", variant: str = "multi",
               capacity: int = CAPACITY):
    """The paper's experiment as a ``repro_torch.gson.RunSpec``.

    ``variant`` is any name in ``repro_torch.gson.VARIANTS`` ("multi" is
    the paper's contribution; "single" / "indexed" its baselines;
    "multi-fused" the fused schedule).
    """
    from repro_torch import gson
    return gson.RunSpec(
        variant=variant,
        model=config,
        sampler=surface,
        capacity=capacity,
        dim=DIM,
        max_deg=MAX_DEG,
    )

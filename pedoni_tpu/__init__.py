"""pedoni-tpu: a crowd-simulation framework in JAX for NVIDIA GPUs.

A ground-up re-design of the capabilities of the Rust/OpenCL reference
``qt2/pedoni``: Helbing social-force pedestrian dynamics with fast-marching
navigation fields, uniform-grid neighbor search, TOML scenarios, headless
benchmarking with JSON step metrics, and multi-device spatial sharding over
a ``jax.sharding.Mesh`` with a halo exchange between neighbor strips.
"""

from .field import Field, FieldMaps
from .physics import Physics
from .scenario import Scenario, Segment, load_scenario, loads_scenario
from .sim import Simulator, SimulatorOptions

__version__ = "0.1.0"

__all__ = [
    "Field",
    "FieldMaps",
    "Physics",
    "Scenario",
    "Segment",
    "Simulator",
    "SimulatorOptions",
    "load_scenario",
    "loads_scenario",
]

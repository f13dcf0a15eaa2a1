"""The paper's own 'architecture': the DPA-Store KV service itself, sized to
the evaluation setup (Sec 4.1: 25-50M keys, 176 traverser shards).  Used by
the dry-run to prove the request-sharded store lowers on the production
meshes alongside the LM cells."""
from dataclasses import dataclass


@dataclass(frozen=True)
class ServiceConfig:
    name: str = "dpastore-service"
    n_keys: int = 50_000_000
    wave_size: int = 65536  # requests per wave across the mesh
    eps_inner: int = 4
    eps_leaf: int = 8
    depth: int = 3
    value_bytes: int = 8


CONFIG = ServiceConfig()

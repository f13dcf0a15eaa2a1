"""Config registry of the port: ``--arch <id>`` -> ``ArchConfig``.

Copies of the JAX package's ``configs/``: ``base`` (``ArchConfig``,
``ShapeConfig``, ``SHAPES``, ``cell_supported``, ``reduced``), the ten
model configs in ``ARCHS`` and ``dpastore_service``, the KV service sized
to the paper's evaluation (``launch/kv_dryrun.py`` reads it).  They import
nothing of either package."""

from .base import ArchConfig, ShapeConfig, SHAPES, cell_supported, reduced
from .hubert_xlarge import CONFIG as hubert_xlarge
from .llama4_scout_17b_a16e import CONFIG as llama4_scout
from .mixtral_8x7b import CONFIG as mixtral_8x7b
from .mamba2_1p3b import CONFIG as mamba2_1p3b
from .deepseek_coder_33b import CONFIG as deepseek_coder_33b
from .glm4_9b import CONFIG as glm4_9b
from .llama3_405b import CONFIG as llama3_405b
from .h2o_danube_3_4b import CONFIG as h2o_danube
from .pixtral_12b import CONFIG as pixtral_12b
from .jamba_1p5_large_398b import CONFIG as jamba_1p5_large
from .dpastore_service import CONFIG as dpastore_service

ARCHS = {
    c.name: c
    for c in [
        hubert_xlarge,
        llama4_scout,
        mixtral_8x7b,
        mamba2_1p3b,
        deepseek_coder_33b,
        glm4_9b,
        llama3_405b,
        h2o_danube,
        pixtral_12b,
        jamba_1p5_large,
    ]
}

__all__ = [
    "ArchConfig",
    "ShapeConfig",
    "SHAPES",
    "ARCHS",
    "cell_supported",
    "reduced",
    "dpastore_service",
]

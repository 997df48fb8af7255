"""Graph tables, layers, the generator, the CVAE and the JAX weight import."""

from . import convert, cvae, generator, graph, layers
from .cvae import CVAEConfig
from .generator import GeneratorConfig

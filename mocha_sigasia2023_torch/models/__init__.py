"""Graph tables, layers, the generator, the CVAE, the projector and the
weight import."""

from . import convert, cvae, generator, graph, layers, projector
from .cvae import CVAEConfig
from .generator import GeneratorConfig
from .projector import ProjectorConfig

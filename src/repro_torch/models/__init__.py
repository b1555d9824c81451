"""The paper's simulator networks at their published widths, and the LM
stack's full-sequence forward (dense family)."""

from .api import ModelAPI, cell_applicable, get_model, input_spec_shapes
from .config import SHAPES, SUBQUADRATIC, ModelConfig, ShapeCell
from .dnn import NETWORKS, har_net, mnist_net, okg_net

__all__ = ["ModelAPI", "ModelConfig", "NETWORKS", "SHAPES", "SUBQUADRATIC",
           "ShapeCell", "cell_applicable", "get_model", "har_net",
           "input_spec_shapes", "mnist_net", "okg_net"]

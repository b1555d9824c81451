"""The paper's simulator networks at their published widths, and the LM
stack: the forward, the losses and KV-cache / recurrent decode of the
dense, moe and vlm families (``transformer``, with ``moe``), the ssm
family (``mamba2``), the hybrid family (``zamba2``) and the encdec family
(``whisper``); ``shardctx`` holds the launcher's activation specs."""

from . import shardctx
from .api import (ModelAPI, cache_spec_shapes, cell_applicable, get_model,
                  input_spec_shapes)
from .config import SHAPES, SUBQUADRATIC, ModelConfig, ShapeCell
from .dnn import NETWORKS, har_net, mnist_net, okg_net

__all__ = ["shardctx", "ModelAPI", "ModelConfig", "NETWORKS", "SHAPES", "SUBQUADRATIC",
           "ShapeCell", "cache_spec_shapes", "cell_applicable", "get_model",
           "har_net", "input_spec_shapes", "mnist_net", "okg_net"]

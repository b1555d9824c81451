"""GENESIS: compression (pruning, SVD, Tucker/HOOI separation) +
IMpJ-optimal configuration selection (the JAX package's
``repro.compress``; the numpy building blocks are copies of its own, and
the retraining and pricing run on PyTorch and the port's fleet replay)."""

from .genesis import (ConfigResult, DEVICE_WEIGHT_BYTES, LayerChoice,
                      apply_config, estimate_energy, layer_choices,
                      pareto_frontier, select, sweep)
from .prune import nnz, prune_by_sparsity, prune_by_threshold, sparsity_of
from .svd import svd_factor, svd_params, svd_worthwhile
from .tucker import (hooi, separate_conv_spatial, separation_params,
                     tucker2_conv, tucker2_params, tucker_reconstruct)

__all__ = [
    "ConfigResult", "DEVICE_WEIGHT_BYTES", "LayerChoice", "apply_config",
    "estimate_energy", "hooi", "layer_choices", "nnz", "pareto_frontier",
    "prune_by_sparsity", "prune_by_threshold", "select",
    "separate_conv_spatial", "separation_params", "sparsity_of",
    "svd_factor", "svd_params", "svd_worthwhile", "sweep", "tucker2_conv",
    "tucker2_params", "tucker_reconstruct",
]

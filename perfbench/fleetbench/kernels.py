"""The fleet program's kernels by name in a trace, beside the trace's
readers: the fleet metrics' ``run.trace_module``."""

from benchcore.trace import is_copy, kernel_time  # noqa: F401

#: Kernel names, as the profiler reports the program's CUDA kernels.
LANE_KERNEL = "charge_replay_kernel"
FOLD_KERNELS = ("fold_hist_kernel", "fold_ordered_kernel")


def is_other_kernel(name: str) -> bool:
    """A kernel that is neither the lane kernel nor the fold (in a cell
    without the lane kernel: the closed form's)."""
    return not (is_copy(name) or LANE_KERNEL in name
                or any(k in name for k in FOLD_KERNELS))

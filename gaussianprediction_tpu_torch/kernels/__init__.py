"""The port's hand-written CUDA kernels: sources in csrc/, built and loaded
by build.py, launched by the wrappers in ops/expand.py,
ops/rasterize_kernels.py, ops/blend_variants.py, ops/scan.py and
ops/hashgrid_kernels.py.

`launch_counts` counts the launches of each kernel by name. A wrapper adds
one where it launches its kernel and nowhere else, so a run can show that
the main path went through the kernels.
"""
from collections import Counter

launch_counts: Counter = Counter()


def reset_launch_counts() -> None:
    launch_counts.clear()

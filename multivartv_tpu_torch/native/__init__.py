"""Host-side native code of the port: the kd-tree of point-cloud meshes
and the closed-form binning of a regular lattice."""

from multivartv_tpu_torch.native.loader import (available, bin_regular, nearest_brute,
                                                nearest_kdtree)

__all__ = ["available", "bin_regular", "nearest_brute", "nearest_kdtree"]

// The affine scan's float64 instantiations (scan_launch.cuh) at the
// planar quadrotor's n = 6, every lane count whose block fits in shared
// memory, in an object of their own.

#include "scan_launch.cuh"

IPOC_SCAN_ENTRIES(double, n6_affine_f64, ipoc_scan::kAffine, 6)

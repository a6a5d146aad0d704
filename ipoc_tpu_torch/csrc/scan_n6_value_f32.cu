// The value scan's float32 instantiations (scan_launch.cuh) at the
// planar quadrotor's n = 6, every lane count whose block fits in shared
// memory, in an object of their own.

#include "scan_launch.cuh"

IPOC_SCAN_ENTRIES(float, n6_value_f32, ipoc_scan::kValue, 6)

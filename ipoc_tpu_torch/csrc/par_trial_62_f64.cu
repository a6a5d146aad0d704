// The parallel trial's float64 instantiations (par_trial.cuh) at
// the planar quadrotor's (6, 2), every lane count whose block fits in
// shared memory, in an object of their own.

#include "par_trial.cuh"

IPOC_TRIAL_ENTRIES(double, 62_f64, ipoc_trial::Shape<6, 2>)

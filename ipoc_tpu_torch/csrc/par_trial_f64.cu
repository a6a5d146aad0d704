// The parallel trial's float64 instantiations (par_trial.cuh): every
// (nx, nu) shape and lane count, in an object of their own.

#include "par_trial.cuh"

IPOC_TRIAL_ENTRIES(double, f64)

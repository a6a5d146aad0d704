// The parallel trial's float32 instantiations (par_trial.cuh) at
// the planar quadrotor's (6, 2), every lane count whose block fits in
// shared memory, in an object of their own.

#include "par_trial.cuh"

IPOC_TRIAL_ENTRIES(float, 62_f32, ipoc_trial::Shape<6, 2>)
